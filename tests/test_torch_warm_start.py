"""The warm start of the encoders from a pretraining checkpoint and the
encoder freeze of ``finetune_strategy: frozen``, against the JAX
package: ``train/convert.py:load_pretrained_encoders`` against
``stil_tta_tpu/train/convert.py:load_pretrained_encoders`` on a
checkpoint that the port writes (``save_encoder_checkpoint``) from
seeded random weights, the refusals of each registry name, one frozen
STiL step against JAX's (``optax.masked(set_to_zero)`` after Adam), the
freeze in both of the port's Adams, and an exact resume through the CLI
with the frozen moments.

Tolerances. The warm start copies tensors, so its parameters and BN
statistics are held bit for bit, and so are frozen parameters, which
never move. The frozen step runs at float64 on both sides as
``tests/test_torch_train_step.py`` does and takes its tolerances; the
Adam moments of the frozen leaves, which JAX keeps advancing, follow
from gradients that agree to float64 summation order: rtol 1e-7 of the
moment, atol 1e-12 (first) and 1e-15 (second moment, a square of
gradients of order 1e-2 or less). One JAX train-step compile."""

import types

import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import STiL, init_weights
from stil_tta_torch.config import load_config
from stil_tta_torch.ops.batch_norm import BatchNorm2d
from stil_tta_torch.train import optim
from stil_tta_torch.train.convert import (export_state_dict,
                                          load_pretrained_encoders,
                                          load_train_state,
                                          save_encoder_checkpoint,
                                          train_state_from_jax)
from tests.torch_parity import (FIX_CLI, assert_close, cli_resume_exact,
                                x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

FL = [5, 4, 2, 1, 1, 1]
SMALL = ["dataset=synthetic_dvm", "models=resnet18", "img_size=32",
         "num_classes=4", "tabular_embedding_dim=32",
         "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
         "projection_dim=8", "K=16"]
ENCODERS = ("encoder_imaging", "encoder_tabular")


def _pretrained(backbone, path, seed=1):
    """``backbone``'s encoders with seeded random weights and BN running
    statistics written as a pretraining checkpoint, with a projection
    head, prototypes and one unknown key under each encoder, which are
    left over."""
    gen = torch.Generator().manual_seed(seed)
    for sub in ENCODERS:
        init_weights(getattr(backbone, sub), gen)
    with torch.no_grad():
        for mod in backbone.encoder_imaging.modules():
            if isinstance(mod, BatchNorm2d):
                mod.running_mean.normal_(0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    path = save_encoder_checkpoint(backbone, path)
    ckpt = torch.load(path, weights_only=True)
    ckpt["state_dict"].update({
        "projection_head.0.weight": torch.ones(4, 4),
        "prototypes.weight": torch.ones(3, 4),
        "encoder_imaging.fc.weight": torch.ones(2, 2),
        "encoder_tabular.unused": torch.ones(2)})
    torch.save(ckpt, path)
    return path


def _jax_variables(jalgo, port_net, jnp, jax):
    """A JAX variable tree holding the port net's weights."""
    from stil_tta_tpu.train.convert import convert_torch_state_dict
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, 32, 32, 3)),
        jnp.zeros((2, len(FL))), train=False))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    sd = {k: v.numpy() for k, v in port_net.state_dict().items()}
    return convert_torch_state_dict(sd, target)[0]


def test_load_pretrained_encoders_matches_jax(tmp_path, capsys):
    """From one STiL net, both sides load one checkpoint: every parameter
    and BN statistic of the net equal bit for bit (the encoders the
    file's, the rest the net's own), and the same ``Loaded n/N`` lines
    (the unknown keys left over, the head and prototypes filtered out,
    the BN counters counted as loaded). The EMA teacher keeps its
    weights on both sides: JAX's function returns ``params`` and
    ``batch_stats`` alone and its ``evaluate`` replaces those
    (``train/evaluate.py:190-206``); the port fills the student."""
    import jax
    import jax.numpy as jnp

    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.train.convert import \
        load_pretrained_encoders as jax_load_encoders
    algo = STiL(load_config("config_dvm_STiL", SMALL), FL, device="cpu")
    state = algo.init_state(seed=0)
    ema0 = {k: v.clone() for k, v in state.ema.state_dict().items()}
    other = STiL(load_config("config_dvm_STiL", SMALL), FL, device="cpu")
    ckpt = _pretrained(other.net.model, tmp_path / "pretrained.ckpt")
    jalgo = JaxSTiL(jax_load_config("config_dvm_STiL", SMALL), FL)
    variables = _jax_variables(jalgo, algo.net, jnp, jax)
    capsys.readouterr()
    out = jax_load_encoders(variables, str(ckpt))
    jax_lines = capsys.readouterr().out
    assert set(out) == {"params", "batch_stats"}
    load_pretrained_encoders(state.net, ckpt)
    assert capsys.readouterr().out == jax_lines
    assert jax_lines.splitlines() == [
        "Loaded 120/121 torch keys for encoder_imaging.",
        "Loaded 19/20 torch keys for encoder_tabular."]
    want = export_state_dict(out["params"], out["batch_stats"])
    got = state.net.state_dict()
    pre = torch.load(ckpt, weights_only=True)["state_dict"]
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue   # the JAX state keeps no BN counters
        assert np.array_equal(v.numpy(), want[k]), k
        enc = k[len("model."):]
        if enc.split(".")[0] in ENCODERS:
            assert torch.equal(v, pre[enc]), k
    for k, v in state.ema.state_dict().items():
        assert torch.equal(v, ema0[k]), k
    assert not torch.equal(state.ema.encoder_imaging.conv1.weight,
                           state.net.model.encoder_imaging.conv1.weight)


# every registry name by its DVM YAML, and the multimodal FixMatch YAMLs
YAMLS = [("config_dvm_STiL", ()), ("config_dvm_STiL_SAINT", ()),
         ("config_dvm_STiL", ("algorithm_name=Supervised",)),
         ("config_dvm_STiL", ("algorithm_name=TabularEval",
                              "eval_datatype=tabular")),
         ("config_dvm_MMatch", ()), ("config_dvm_CoTrain", ()),
         ("config_dvm_CoTrain_SAINT", ()), ("config_dvm_SimMatch", ()),
         ("config_dvm_CoMatch", ()), ("config_dvm_FreeMatch", ()),
         ("config_dvm_MultiSimMatch", ()), ("config_dvm_MultiCoMatch", ()),
         ("config_dvm_MultiFreeMatch", ())]


@pytest.mark.parametrize("config,extra", YAMLS,
                         ids=[c[len("config_dvm_"):] + "".join(
                             "-" + e.split("=")[1] for e in x[:1])
                             for c, x in YAMLS])
def test_warm_start_refusals_match_jax(tmp_path, capsys, config, extra):
    """Each net either loads on both sides, with the same printed lines,
    or is refused on both: no backbone (the imaging FixMatch nets,
    ``TabularNet``; JAX: ``KeyError`` on ``backbone``) or a SAINT
    tabular encoder (JAX: ``KeyError`` on a key no SAINT checkpoint
    has); the port raises ``ValueError``."""
    import jax
    import jax.numpy as jnp

    from stil_tta_tpu.algorithms.registry import \
        get_algorithm as jax_algorithm
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.train.convert import \
        load_pretrained_encoders as jax_load_encoders
    cfg = load_config(config, SMALL + list(extra))
    net = get_algorithm(cfg.algorithm_name)(cfg, FL, device="cpu").net
    source = net if hasattr(net, "model") else STiL(
        load_config("config_dvm_STiL", SMALL), FL, device="cpu").net
    ckpt = save_encoder_checkpoint(source.model, tmp_path / "p.ckpt")
    jcfg = jax_load_config(config, SMALL + list(extra))
    jalgo = jax_algorithm(jcfg.algorithm_name)(jcfg, FL)
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, 32, 32, 3)),
        jnp.zeros((2, len(FL))), train=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    refused = (not hasattr(net, "model")
               or "SAINT" in cfg.algorithm_name)
    capsys.readouterr()
    if refused:
        with pytest.raises(KeyError):
            jax_load_encoders(variables, str(ckpt))
        with pytest.raises(ValueError, match="warm start"):
            load_pretrained_encoders(net, ckpt)
        return
    jax_load_encoders(variables, str(ckpt))
    jax_lines = capsys.readouterr().out
    load_pretrained_encoders(net, ckpt)
    assert capsys.readouterr().out == jax_lines
    assert len(jax_lines.splitlines()) == 2


def test_frozen_group_in_both_adams():
    """``frozen`` parameters go into a group at learning rate 0 that
    ``set_learning_rate`` leaves alone, in torch's Adam and in the port's
    bfloat16-moment Adam, with weight decay: over two steps (the rate
    changed between them) they do not move; after the first their
    moments equal those of an optimizer without the freeze (after that
    the decayed weights differ); the other parameters follow the same
    path as without the freeze."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen)]
    grads = [[torch.randn(3, 4, generator=gen),
              torch.randn(5, generator=gen)] for _ in range(2)]
    for mu_dtype in (None, "bfloat16"):
        ps = {f: [torch.nn.Parameter(t.clone()) for t in init]
              for f in (False, True)}
        opts = {f: optim.build_optimizer(ps[f], 1e-2, 1e-2,
                                         frozen=ps[f][:1] if f else (),
                                         mu_dtype=mu_dtype)
                for f in (False, True)}
        for i, (lr, g) in enumerate(zip((1e-2, 5e-3), grads)):
            for f, opt in opts.items():
                optim.set_learning_rate(opt, lr)
                for p, gi in zip(ps[f], g):
                    p.grad = gi.clone()
                opt.step()
            if i == 0:
                for p, q in zip(ps[True], ps[False]):
                    for m in ("exp_avg", "exp_avg_sq"):
                        assert torch.equal(opts[True].state[p][m],
                                           opts[False].state[q][m])
        groups = opts[True].param_groups
        assert len(groups) == 2 and groups[1]["frozen"]
        assert groups[1]["lr"] == 0.0 and groups[0]["lr"] == 5e-3
        assert torch.equal(ps[True][0], init[0])
        assert not torch.equal(ps[False][0], init[0])
        assert torch.equal(ps[True][1], ps[False][1])
    assert optim.frozen_parameters(
        types.SimpleNamespace(finetune_strategy="frozen", checkpoint=None),
        torch.nn.Linear(2, 2)) == []


# ---- one frozen STiL step ---------------------------------------------------

B_L, B_U = 4, 12


@pytest.fixture(scope="module")
def frozen_step():
    """One step at epoch 1 on both sides from one initial state, with
    ``finetune_strategy: frozen`` and a checkpoint named (the freeze
    needs only the name)."""
    import jax
    import jax.numpy as jnp

    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.models import backbones as jbackbones
    from tests import test_torch_train_step as step

    def cfg_of(loader):
        cfg = step._cfg(loader)
        cfg.finetune_strategy = "frozen"
        cfg.checkpoint = "pretrained.ckpt"
        return cfg

    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = step._data()
    il, iu = jnp.arange(B_L, dtype=jnp.int32), jnp.arange(B_U,
                                                          dtype=jnp.int32)
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSTiL(cfg_of(jax_load_config), FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)
        algo = STiL(cfg_of(load_config), FL, dtype=torch.float64,
                    device="cpu")
        j0 = step._jax_state(jalgo, step._port_initial_state(algo))
        carried = train_state_from_jax(j0)
        mask = torch.tensor(step._mask_rand(j0))
        jstate = jax.jit(jalgo.make_train_step().__wrapped__)(
            j0, jcl, jcu, il, iu, jnp.asarray(1, jnp.int32))
        adam = [s for s in jstate.opt_state.inner_state
                if hasattr(s, "mu")][0]
        moments = {m: export_state_dict(
            jax.tree_util.tree_map(np.asarray, getattr(adam, m)))
            for m in ("mu", "nu")}
    algo = STiL(cfg_of(load_config), FL, dtype=torch.float64, device="cpu")
    step._no_fusion_dropout(algo.net)
    state = algo.init_state(seed=0)
    load_train_state(state, carried)
    algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                           torch.arange(B_U), 1, mask_rand=mask)
    return step, jstate, state, carried, moments


def test_frozen_step_matches_jax(frozen_step):
    """Loss logs, every parameter, the EMA, prototype sums and DA ring as
    in the unfrozen step's test; the encoders' parameters did not move
    (bit for bit), their BN running statistics did, the fusion and heads
    did; the frozen leaves' Adam moments equal JAX's."""
    step, jstate, state, carried, moments = frozen_step
    step._compare_states(jstate, state)
    start = carried["net"]
    frozen = {id(p) for p in optim.frozen_parameters(types.SimpleNamespace(
        finetune_strategy="frozen", checkpoint="pretrained.ckpt"),
        state.net)}
    names = dict(state.net.named_parameters())
    assert frozen and len(frozen) < len(names)
    for k, p in names.items():
        if id(p) in frozen:
            assert torch.equal(p.detach(), start[k].double()), k
            st = state.optimizer.state[p]
            for m, key, atol in (("mu", "exp_avg", 1e-12),
                                 ("nu", "exp_avg_sq", 1e-15)):
                assert_close(st[key], moments[m][k], 1e-7, atol, f"{m} {k}")
            assert float(st["exp_avg_sq"].abs().max()) > 0, k
    for k in ("model.reduce.weight", "model.classifier_multimodal.weight",
              "model.projection_si.model.0.weight"):
        assert not torch.equal(names[k].detach(), start[k].double()), k
    sd = state.net.state_dict()
    key = "model.encoder_imaging.bn1.running_mean"
    assert not torch.equal(sd[key], start[key].double())


# ---- the CLI: warm start, freeze, int8 teacher, exact resume ---------------

def test_cli_warm_start_frozen_resumes_exactly(tmp_path):
    """``python -m stil_tta_torch.run`` with ``checkpoint=<.ckpt>
    finetune_strategy=frozen teacher_int8=true`` on the CPU: two epochs
    straight through equal one epoch and a resumed second bit for bit,
    the Adam moments of the frozen encoders included; the encoders keep
    the file's weights, and the frozen group stays at learning rate 0."""
    from stil_tta_torch.data.datasets import load_sources
    cfg = load_config("config_dvm_STiL", FIX_CLI[2:])
    fl = load_sources(cfg)["train_labelled"].field_lengths
    net = STiL(cfg, fl, device="cpu").net
    ckpt = _pretrained(net.model, tmp_path / "pretrained.ckpt")
    pre = torch.load(ckpt, weights_only=True)["state_dict"]
    resumed = cli_resume_exact(
        "config_dvm_STiL", tmp_path, f"checkpoint={ckpt}",
        "finetune_strategy=frozen", "teacher_int8=true",
        "strict_prototypes=false")
    for k, v in resumed["net"].items():
        enc = k[len("model."):]
        if (enc.split(".")[0] in ENCODERS
                and not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked"))):
            assert torch.equal(v, pre[enc]), k
    groups = resumed["optimizer"]["param_groups"]
    assert len(groups) == 2 and groups[1]["frozen"]
    assert groups[1]["lr"] == 0.0 and groups[0]["lr"] > 0.0
    # a frozen leaf that the loss reaches has advancing moments (a few,
    # such as the missing-value token, get no gradient here)
    moments = [resumed["optimizer"]["state"][i]["exp_avg_sq"]
               for i in groups[1]["params"]]
    assert sum(float(m.abs().max()) > 0 for m in moments) > \
        0.9 * len(moments)
