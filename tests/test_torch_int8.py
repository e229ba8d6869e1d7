"""The port's int8 image tower against the JAX package's: the quantized
convolution (``stil_tta_torch/ops/quant_conv.py`` against
``stil_tta_tpu/models/resnet.py:quant_conv_apply``), the resnet18 int8
eval forward, one STiL train step with ``teacher_int8``, ``Predictor``
with ``int8=True``, the refusals, and (on the card) the integer-GEMM
route against the plain one.

Tolerances. The convolution is held bit for bit: both sides quantize
with the same float32 operations (a division by the scale, rounding
half to even), the s32 sums are exact on both (XLA's integer conv; the
port's float64 conv of integers below 2^53), and the epilogue is the
same float32 product. The float64 comparisons (JAX in x64, its
``jnp.float32`` read as float64 in the resnet module, so the scales and
the quantizing division are float64 as the port's are for a float64
tower) see the same int8 values on both sides unless a value sits within
a float64 rounding of a rounding boundary, which these inputs do not:
what separates the sides is float64 summation order in the exact layers
(BN, pooling, the heads), so rtol 1e-8 as ``tests/test_torch_models.py``
states, and the train step's tolerances are
``tests/test_torch_train_step.py``'s. One JAX train-step compile."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.models import resnet as port_resnet
from stil_tta_torch.models.resnet import resnet18, resnet50
from stil_tta_torch.ops import quant_conv as qc
from stil_tta_torch.serve import Predictor
from stil_tta_torch.serve import main as serve_main
from stil_tta_torch.train.convert import (load_train_state,
                                          state_dict_from_jax,
                                          train_state_from_jax)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs under several xdist
    workers. Restored afterwards, so other files' tests keep theirs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    """The JAX package and the parity helpers, imported by the CPU tests
    alone: the card tests of this file also run where only PyTorch is
    installed (``python -m pytest --noconftest -m gpu
    tests/test_torch_int8.py``)."""
    import jax
    import jax.numpy as jnp

    from stil_tta_tpu.algorithms.registry import get_algorithm as algorithm
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.data.source import synthetic_source
    from stil_tta_tpu.models import backbones as jbackbones
    from stil_tta_tpu.models import resnet as jr
    from stil_tta_tpu.serve import Predictor as JaxPredictor
    from tests import test_torch_train_step as step
    from tests import torch_parity as parity
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, algorithm=algorithm, JaxSTiL=JaxSTiL,
        load_config=jax_load_config, synthetic_source=synthetic_source,
        jbackbones=jbackbones, jr=jr, JaxPredictor=JaxPredictor, step=step,
        p=parity)


FL = [5, 4, 2, 1, 1, 1]
F64 = torch.float64

# (kernel, stride, padding, cin, cout, size): ResNet's 1x1, 3x3 at
# stride 1 and 2, the 1x1/s2 downsample, and the 7x7/s2/p3 stem
CONV_CASES = [(1, 1, 0, 16, 24, 12), (3, 1, 1, 16, 8, 12),
              (3, 2, 1, 16, 8, 12), (1, 2, 0, 16, 32, 12),
              (7, 2, 3, 3, 64, 16)]


def _port_x(x):
    """An NHWC float32 array as the port's NCHW channels-last bf16."""
    return torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)\
        .contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: f"k{c[0]}s{c[1]}p{c[2]}")
def test_quant_conv_matches_jax_bitwise(jx, case, out):
    """bf16 x, float32 w: the port's output equals ``quant_conv_apply``'s
    bit for bit, and so do the im2col rows times the weight matrix of
    the card route (here summed in int64) and the plain s32 sums."""
    jnp = jx.jnp
    k, s, p, cin, cout, size = case
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jx.jr.quant_conv_apply(
        xb, jnp.asarray(w), s, p, getattr(jnp, out)).astype(jnp.float32))
    x = _port_x(np.asarray(xb.astype(jnp.float32)))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = qc.quant_conv2d(x, wt, s, p, getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, want)
    assert np.count_nonzero(want) > want.size // 2
    x_q, w_q, _, _ = qc.quantize(x, wt)
    cols, (b, ho, wo) = qc.im2col(x_q, k, k, s, p)
    assert cols.shape[0] == 1
    assert cols.shape[2] % 8 == 0 and cols.shape[1] >= 17
    y = cols[0].long() @ qc.weight_matrix(w_q, cols.shape[-1])[0].long()
    y = y[:b * ho * wo, :cout].reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
    assert torch.equal(y.int(), qc.int8_conv_plain(x_q, w_q, s, p))


def test_stem_gemm_pads_k_to_152():
    """The 7x7 stem's K = 147 is padded with zero columns to 152, the
    weight with zero rows; an (M <= 16)-row GEMM gets zero rows to 17."""
    x_q = torch.ones(1, 3, 8, 8, dtype=torch.int8)
    cols, (b, ho, wo) = qc.im2col(x_q, 7, 7, 2, 3)
    assert (b, ho, wo) == (1, 4, 4) and cols.shape == (1, 17, 152)
    assert not cols[:, :, 147:].any() and not cols[:, 16:].any()
    wm = qc.weight_matrix(torch.ones(64, 3, 7, 7, dtype=torch.int8), 152)
    assert wm.shape == (1, 152, 64) and not wm[:, 147:].any()
    assert wm[0].t().is_contiguous()


def test_quant_conv_refuses_a_device_it_has_no_route_for():
    x = torch.empty(1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        qc.quant_conv2d(x, torch.empty(4, 3, 3, 3, device="meta"), 1, 1,
                        torch.float32)


def test_resnet18_int8_eval_forward_matches_jax(jx):
    """``ResNet(int8=True)`` eval forward of both sides at float64, every
    feature map; the int8 forward is not the exact one; train mode
    ignores the flag, as in JAX."""
    jax, jnp, jr, pp = jx.jax, jx.jnp, jx.jr, jx.p
    x = np.random.RandomState(0).rand(4, 32, 32, 3)
    with pp.x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "jnp", pp.jnp64())
        tower = jr.resnet18(return_all_feature_maps=True, dtype=jnp.float64)
        key = jax.random.key(0)
        variables = pp.to_numpy(dict(jax.jit(lambda a: tower.init(
            {"params": key}, a, train=False))(jnp.asarray(x))), np.float64)
        apply = jax.jit(tower.apply, static_argnames=("train", "int8"))
        jq = apply(variables, jnp.asarray(x), train=False, int8=True)
        jexact = apply(variables, jnp.asarray(x), train=False)
    port = pp.load_port(resnet18(return_all_feature_maps=True, dtype=F64),
                        variables).eval()
    with torch.no_grad():
        feats = port(torch.from_numpy(x), int8=True)
        exact = port(torch.from_numpy(x))
    for i, (f, jf, e, je) in enumerate(zip(feats, jq, exact, jexact)):
        pp.assert_close(f, np.asarray(jf), 1e-8, 1e-10, f"int8 map {i}")
        pp.assert_close(e, np.asarray(je), 1e-8, 1e-10, f"exact map {i}")
        assert float((f - e).abs().max()) > 1e-4 * float(e.abs().max())
    port.train()
    with torch.no_grad():
        sd = {k: v.clone() for k, v in port.state_dict().items()}
        a = port(torch.from_numpy(x), int8=True)[-1]
        port.load_state_dict(sd)
        b = port(torch.from_numpy(x))[-1]
    assert torch.equal(a, b)


# ---- one STiL train step with teacher_int8 ---------------------------------

B_L, B_U = 4, 12


def _cfg(jx, loader, int8=True):
    """``tests/test_torch_train_step.py``'s config with ``teacher_int8``."""
    cfg = jx.step._cfg(loader)
    cfg.teacher_int8 = int8
    return cfg


@pytest.fixture(scope="module")
def int8_step(jx):
    """One step at epoch 1 on both sides from one initial state (the
    EMA teacher's image tower int8), and the port's step with the exact
    teacher from the same state."""
    jax, jnp, step, pp = jx.jax, jx.jnp, jx.step, jx.p

    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jx.jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = step._data()
    il, iu = jnp.arange(B_L, dtype=jnp.int32), jnp.arange(B_U,
                                                          dtype=jnp.int32)
    with pp.x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.jbackbones, "MITransformerLayer", dropfree)
        mp.setattr(jx.jr, "jnp", pp.jnp64())
        jalgo = jx.JaxSTiL(_cfg(jx, jx.load_config), FL, dtype=jnp.float64)
        assert jalgo.net.teacher_int8
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)
        algo = STiL(_cfg(jx, load_config), FL, dtype=F64, device="cpu")
        assert algo.net.teacher_int8
        j0 = step._jax_state(jalgo, step._port_initial_state(algo))
        carried = train_state_from_jax(j0)
        mask = torch.tensor(step._mask_rand(j0))
        jstate = jax.jit(jalgo.make_train_step().__wrapped__)(
            j0, jcl, jcu, il, iu, jnp.asarray(1, jnp.int32))

    def port_step(int8):
        algo = STiL(_cfg(jx, load_config, int8), FL, dtype=F64,
                    device="cpu")
        step._no_fusion_dropout(algo.net)
        state = algo.init_state(seed=0)
        load_train_state(state, carried)
        return algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                                      torch.arange(B_U), 1, mask_rand=mask)

    return jstate, port_step(True), port_step(False)


def test_teacher_int8_step_matches_jax(jx, int8_step):
    """Loss logs, parameters (so the gradients), EMA, prototype sums, DA
    ring and train accuracy after one step, as
    ``tests/test_torch_train_step.py`` holds the exact step."""
    jstate, pstate, _ = int8_step
    assert pstate.step == 1 == int(jstate.step)
    jx.step._compare_states(jstate, pstate)


def test_teacher_int8_changes_the_step(int8_step):
    """The int8 teacher's targets differ from the exact teacher's: the
    flag reaches the EMA forward. The prototype sums add the teacher's
    features of the rows over ``th1``, so they differ."""
    _, pstate, exact = int8_step
    assert not torch.equal(pstate.prototypes_sum, exact.prototypes_sum)


def test_micro_batched_teacher_quantizes_per_chunk(jx, monkeypatch):
    """With ``micro_batches: 2`` the teacher runs per chunk, so each int8
    conv sees the chunk's rows and takes the chunk's activation scale
    (``resnet.py:311-318``): 2 chunks x resnet18's 20 convs, each of
    B / 2 rows; the student's train-mode convs stay exact."""
    rows = []

    def record(x, weight, stride, padding, out_dtype, groups=1):
        rows.append(x.shape[0])
        return qc.quant_conv2d(x, weight, stride, padding, out_dtype, groups)

    monkeypatch.setattr(port_resnet, "quant_conv2d", record)
    cfg = _cfg(jx, load_config)
    cfg.micro_batches = 2
    algo = STiL(cfg, FL, dtype=torch.float32, device="cpu")
    state = algo.init_state(seed=0)
    (_, cl), (_, cu) = jx.step._data()
    algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                           torch.arange(B_U), 1)
    assert rows == [(B_L + B_U) // 2] * 40


# ---- serving ---------------------------------------------------------------

@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict


def test_predictor_int8_matches_jax_with_a_padded_tail(jx):
    """``Predictor(int8=True)`` of both sides on the same float64 weights
    and inputs, 8 samples in batches of 3 (the tail batch of 2 padded by
    its first row, which joins the batch's activation scale). The eval
    transform is the identity on both sides (each would resize in
    float32, one rounding apart). Probabilities are float32 on both:
    rtol 1e-6. The int8 probabilities are not the exact ones."""
    jax, jnp, pp = jx.jax, jx.jnp, jx.p
    rng = np.random.RandomState(3)
    images = rng.rand(8, 32, 32, 3)
    tabular = np.concatenate(
        [np.stack([rng.randint(0, c, 8) for c in FL[:3]], 1),
         rng.randn(8, 3)], 1).astype(np.float32)
    with pp.x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.jr, "jnp", pp.jnp64())
        jalgo = jx.JaxSTiL(_cfg(jx, jx.load_config), FL, dtype=jnp.float64)
        jalgo.aug_eval = lambda key, x: x
        key = jax.random.key(0)
        variables = pp.to_numpy(dict(jax.jit(
            lambda img, tab: jalgo.net.init({"params": key, "dropout": key},
                                            img, tab, train=False))(
            jnp.zeros((2, 32, 32, 3)), jnp.asarray(tabular[:2]))),
            np.float64)
        state = _State(variables["params"], variables["batch_stats"])
        want = jx.JaxPredictor(jalgo, state, batch_size=3, int8=True)(
            images, tabular)
    algo = STiL(_cfg(jx, load_config), FL, dtype=F64, device="cpu")
    algo.net.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    algo.aug_eval = lambda x: x
    got = Predictor(algo, batch_size=3, int8=True)(images, tabular)
    assert got.shape == (8, 4) and got.dtype == np.float32
    pp.assert_close(got, want, 1e-6, 1e-9)
    exact = Predictor(algo, batch_size=3)(images, tabular)
    assert not np.allclose(exact, got, rtol=1e-6, atol=1e-9)


# the nets whose forward takes no int8_image, as named by the registry
NO_INT8 = [("MMatch", "config_dvm_MMatch", ()),
           ("SimMatch", "config_dvm_SimMatch", ()),
           ("TabularEval", "config_dvm_STiL",
            ("algorithm_name=TabularEval", "eval_datatype=tabular"))]
SMALL = ["dataset=synthetic_dvm", "models=resnet18", "img_size=32",
         "num_classes=4", "tabular_embedding_dim=32",
         "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
         "projection_dim=8"]


@pytest.mark.parametrize("name,config,extra", NO_INT8,
                         ids=[n for n, _, _ in NO_INT8])
def test_int8_serving_is_refused_where_jax_refuses_it(jx, name, config,
                                                      extra):
    """int8 serving of a net without ``int8_image`` raises ``ValueError``
    on both sides; STiL's nets take it."""
    cfg = load_config(config, SMALL + list(extra))
    algo = get_algorithm(cfg.algorithm_name)(cfg, FL, device="cpu")
    with pytest.raises(ValueError, match="int8 serving unsupported"):
        Predictor(algo, int8=True)
    jcfg = jx.load_config(config, SMALL + list(extra))
    jalgo = jx.algorithm(jcfg.algorithm_name)(jcfg, FL)
    with pytest.raises(ValueError, match="int8 serving unsupported"):
        jx.JaxPredictor(jalgo, _State(None, None), int8=True)
    for stil in ("STiL", "STiL_SAINT", "Supervised"):
        cfg = load_config("config_dvm_STiL",
                          SMALL + [f"algorithm_name={stil}"])
        assert Predictor(get_algorithm(stil)(cfg, FL, device="cpu"),
                         int8=True).kw == {"int8_image": True}


def test_serve_cli_int8_scores_a_split(jx, tmp_path):
    """``python -m stil_tta_torch.serve --int8`` on the CPU, from a
    reference-layout ``.ckpt`` of seeded weights."""
    jx.synthetic_source(6, num_classes=4, field_lengths=FL, image_size=40,
                        seed=5).save(tmp_path / "split")
    algo = STiL(load_config("config_dvm_STiL", SMALL), FL, device="cpu")
    algo.init_state(seed=0)
    ckpt = tmp_path / "w.ckpt"
    torch.save({"state_dict": algo.net.state_dict()}, ckpt)
    out = tmp_path / "pred.csv"
    assert serve_main(["--config-name", "config_dvm_STiL", "--checkpoint",
                       str(ckpt), "--source", str(tmp_path / "split"),
                       "--out", str(out), "--device", "cpu", "--int8",
                       "--batch-size", "4", *SMALL]) == 0
    assert len(out.read_text().splitlines()) == 7


# ---- on the card -----------------------------------------------------------

# (batch, cin, size, cout, kernel, stride, padding): ResNet-50's stem
# (K = 147, padded), a 1x1, a 3x3 at stride 1 and 2, a 1x1/s2
# downsample, and a stage-4 1x1 whose GEMM has M = 16 rows (padded)
CARD_SHAPES = [(16, 3, 128, 64, 7, 2, 3), (16, 64, 32, 64, 1, 1, 0),
               (16, 64, 32, 64, 3, 1, 1), (16, 128, 32, 128, 3, 2, 1),
               (16, 256, 32, 512, 1, 2, 0), (1, 512, 4, 2048, 1, 1, 0)]


def _card_inputs(shape, seed):
    b, cin, size, cout, k, _, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, cin, size, size, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, generator=gen, device="cuda") * 0.05
    return x, w


@pytest.mark.gpu
def test_card_route_matches_plain_bitwise():
    """The integer GEMM's s32 sums equal the float64 conv's of the same
    int8 tensors on the card, bit for bit; the bf16 and float32 outputs
    equal the plain route's on the card and on the CPU; two calls agree
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for i, shape in enumerate(CARD_SHAPES):
        x, w = _card_inputs(shape, i)
        s, p = shape[5], shape[6]
        x_q, w_q, _, _ = qc.quantize(x, w)
        y = qc.int8_conv_card(x_q, w_q, s, p)
        assert y.dtype == torch.int32
        assert torch.equal(y, qc.int8_conv_plain(x_q, w_q, s, p)), shape
        for dt in (torch.bfloat16, torch.float32):
            got = qc.quant_conv2d(x, w, s, p, dt)
            assert torch.equal(got, qc.quant_conv2d(x, w, s, p, dt))
            assert torch.equal(got, qc.quant_conv2d_plain(x, w, s, p, dt))
            assert torch.equal(got.cpu(), qc.quant_conv2d(
                x.cpu(), w.cpu(), s, p, dt)), (shape, dt)


@pytest.mark.gpu
def test_card_tensor_never_takes_the_plain_route(monkeypatch):
    """A CUDA tensor runs ``torch._int_mm``: with the plain route gone it
    still computes, and a failing integer GEMM raises (no float
    fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w = _card_inputs(CARD_SHAPES[2], 0)
    want = qc.quant_conv2d(x, w, 1, 1, torch.bfloat16)

    def no_plain(*a, **k):
        raise AssertionError("plain route taken for a CUDA tensor")

    monkeypatch.setattr(qc, "int8_conv_plain", no_plain)
    assert torch.equal(qc.quant_conv2d(x, w, 1, 1, torch.bfloat16), want)

    def broken(*a, **k):
        raise RuntimeError("integer GEMM failed")

    monkeypatch.setattr(torch, "_int_mm", broken)
    with pytest.raises(RuntimeError, match="integer GEMM failed"):
        qc.quant_conv2d(x, w, 1, 1, torch.bfloat16)
    tower = resnet50(dtype=torch.bfloat16).cuda().eval()
    with pytest.raises(RuntimeError, match="integer GEMM failed"):
        with torch.no_grad():
            tower(torch.rand(2, 64, 64, 3, device="cuda"), int8=True)
