"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both sides as
arrays. JAX stays on the CPU. Float64 comparisons enable JAX's x64 mode
only inside :func:`x64`, so other test files in the same worker keep the
float32 default.
"""

import contextlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
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
    """Variables of ``module`` in ``dtype``: the tree of its ``init`` with
    key 0, traced abstractly (nothing is drawn or compiled; an eager init
    compiles every distinct initialiser and shape op by op), filled with
    seeded numpy values: a weight of two or more axes normal over the
    square root of its fan-in, a BatchNorm or LayerNorm scale and a
    running variance in [0.5, 1.5), other vectors normal at 0.1."""
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, *args, **kw))
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if len(s.shape) >= 2:
            fan = int(np.prod(s.shape[:-1]))
            value = rng.randn(*s.shape) / np.sqrt(max(fan, 1))
        elif name in ("scale", "var"):
            value = rng.rand(*s.shape) + 0.5
        else:
            value = rng.randn(*s.shape) * 0.1
        return value.astype(dtype if np.issubdtype(s.dtype, np.floating)
                            else s.dtype)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


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
        # the teacher mirrors the backbone under ``model``, or the whole
        # net (ImagingNet)
        pre = "model." if hasattr(port_state.net, "model") else ""
        ema, _ = convert_torch_state_dict(
            {pre + k: v.numpy()
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


# ---------------------------------------------------------------------------
# augmentation draws (tests/test_torch_train_parts.py,
# tests/test_torch_match_views.py)

def jax_augment_draws(pipe, key, b: int, h: int, w: int,
                      rate: float = 1.0):
    """The parameters a JAX ``AugmentPipeline`` draws from ``key`` for a
    batch of ``b`` (h, w) images, replaying ``__call__``'s and
    ``_augment_one``'s key splits (``augment.py:317-392``: per sample,
    ``ks[0]`` the jitter's five keys, ``ks[1]`` grayscale, ``ks[2]`` the
    blur's two keys before or after the crop, ``ks[3]`` the crop box,
    ``ks[4]`` the flip, ``ks[5]`` the rotation angle), in the port's
    names."""
    from stil_tta_tpu.data import augment as jaug
    k_gate, k_aug = jax.random.split(key)
    u = lambda k, lo=0.0, hi=1.0: float(  # noqa: E731
        jax.random.uniform(k, minval=lo, maxval=hi))
    names = ["y0", "x0", "ch", "cw", "flip"]
    jitter = pipe.jitter
    if jitter is not None:
        names += ["jitter_on", "brightness", "contrast", "saturation"]
        names += ["hue"] if jitter[3] > 0 else []
    names += ["gray_on"] if pipe.gray_p > 0 else []
    names += ["blur_sigma", "blur_on"] if pipe.blur_ksize > 0 else []
    names += ["angle"] if pipe.rotate_limit > 0 else []
    p = {k: [] for k in names}
    for key_i in jax.random.split(k_aug, b):
        ks = jax.random.split(key_i, 6)
        if jitter is not None:
            kj = jax.random.split(ks[0], 5)
            p["jitter_on"].append(u(kj[0]) < pipe.jitter_p)
            for name, k, x in zip(("brightness", "contrast", "saturation"),
                                  kj[1:4], jitter):
                p[name].append(u(k, max(0.0, 1.0 - x), 1.0 + x))
            if jitter[3] > 0:
                p["hue"].append(u(kj[4], -jitter[3], jitter[3]))
        if pipe.gray_p > 0:
            p["gray_on"].append(u(ks[1]) < pipe.gray_p)
        if pipe.blur_ksize > 0:
            kb1, kb2 = jax.random.split(ks[2])
            p["blur_sigma"].append(u(kb1, *pipe.blur_sigma))
            p["blur_on"].append(u(kb2) < pipe.blur_p)
        box = jaug.sample_crop_box(ks[3], h, w, pipe.crop_scale,
                                   pipe.crop_ratio)
        for name, v in zip(("y0", "x0", "ch", "cw"), box):
            p[name].append(float(v))
        p["flip"].append(u(ks[4]) < pipe.hflip_p)
        if pipe.rotate_limit > 0:
            lim = jnp.deg2rad(pipe.rotate_limit)
            p["angle"].append(u(ks[5], -lim, lim))
    out = {k: torch.tensor(v) for k, v in p.items()}
    out["gate"] = (torch.ones(b, dtype=torch.bool) if rate >= 1.0 else
                   torch.tensor(np.asarray(
                       jax.random.uniform(k_gate, (b,)) < rate)))
    return out


# ---------------------------------------------------------------------------
# SimMatch, CoMatch and FreeMatch (tests/test_torch_{simmatch,comatch,
# freematch}.py)

FIX_L, FIX_U = 6, 12     # rows of the labelled and unlabelled caches
IDX_L = [4, 1, 5, 2]     # the labelled batch: dataset rows, out of order
IDX_U = list(range(FIX_U))


def fixmatch_data(field_lengths=(5, 4, 2, 1, 1, 1), img: int = 32,
                  num_classes: int = 4):
    """``((jax_cache_l, port_cache_l), (jax_cache_u, port_cache_u))`` of
    ``FIX_L`` labelled and ``FIX_U`` unlabelled rows made with numpy from
    seed 0: uint8 images on the port's side, the same scaled to [0, 1] in
    float32 on the JAX side (the port's views compute x / 255)."""
    rng = np.random.RandomState(0)
    n = FIX_L + FIX_U
    imgs = rng.randint(0, 256, (n, img, img, 3)).astype(np.uint8)
    ncat = sum(1 for f in field_lengths if f > 1)
    tabs = np.concatenate([
        np.stack([rng.randint(0, c, n) for c in field_lengths[:ncat]], 1),
        rng.randn(n, len(field_lengths) - ncat)], 1).astype(np.float32)
    y = rng.randint(0, num_classes, n)
    out = []
    for sl in (slice(0, FIX_L), slice(FIX_L, n)):
        out.append(({"images": jnp.asarray(
                         imgs[sl].astype(np.float32) / np.float32(255)),
                     "tabular": jnp.asarray(tabs[sl]),
                     "labels": jnp.asarray(y[sl].astype(np.int32)),
                     "labelled": jnp.asarray(np.ones(y[sl].shape, bool))},
                    {"images": torch.from_numpy(imgs[sl]),
                     "tabular": torch.from_numpy(tabs[sl]),
                     "labels": torch.from_numpy(y[sl]),
                     "labelled": torch.ones(y[sl].shape, dtype=bool)}))
    return out


def jnp64():
    """``jax.numpy`` with ``float32`` reading as float64, for a JAX module
    whose masks, gates and buffers are float32."""
    import types
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.float32 = jnp.float64
    return ns


def fixed_views(algo, port: bool) -> None:
    """Deterministic, distinct views on both sides, in place of the
    random recipes (held in ``tests/test_torch_match_views.py``): the
    labelled and weak views are the image (x / 255 on the port's side)
    and the row; the strong view flips the image left-right and rolls the
    rows by one; the second strong view flips it upside down and rolls
    them by two."""
    if port:
        img = lambda x: x.float() / 255          # noqa: E731
        flip = lambda x, a: torch.flip(x, [a])   # noqa: E731
        roll = lambda t, n: torch.roll(t, n, 0)  # noqa: E731
    else:
        img = lambda x: x                        # noqa: E731
        flip = lambda x, a: jnp.flip(x, a)       # noqa: E731
        roll = lambda t, n: jnp.roll(t, n, 0)    # noqa: E731

    def labeled(key, images, tabular, marginal):
        return img(images), tabular

    def weak_strong(key, images, tabular, marginal, two_strong=False):
        x = img(images)
        s2 = ((flip(x, 1), roll(tabular, 2)) if two_strong
              else (None, None))
        return (x, tabular), (flip(x, 2), roll(tabular, 1)), s2

    algo.labeled_views = labeled
    algo.weak_strong_views = weak_strong


def fixmatch_steps(jmod, jcls, pcls, cfg_of, fill=None, patch=(),
                   epoch: int = 1):
    """One train step of the JAX family ``jcls`` (module ``jmod``, run in
    x64 with ``jnp.float32`` read as float64, as are the modules of
    ``patch``) and one of the port's ``pcls`` from one state, each with
    :func:`fixed_views`, on :func:`fixmatch_data` at ``IDX_L`` /
    ``IDX_U``. ``cfg_of(loader, *overrides)`` gives the config;
    ``fill(jstate)`` may
    put buffers into the JAX state before the port takes it. Returns
    ``(jax state after, port state after, the carried initial state)``;
    the JAX step is compiled once."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.train.convert import train_state_from_jax
    from stil_tta_tpu.config import load_config as jax_load_config
    (jcl, cl), (jcu, cu) = fixmatch_data()
    fl = cfg_of(load_config).field_lengths
    with x64(), pytest.MonkeyPatch.context() as mp:
        for mod in (jmod,) + tuple(patch):
            mp.setattr(mod, "jnp", jnp64())
        jalgo = jcls(cfg_of(jax_load_config), fl, dtype=jnp.float64)
        fixed_views(jalgo, port=False)
        algo = pcls(cfg_of(load_config), fl, dtype=torch.float64,
                    device="cpu")
        j0 = jax_match_state(jalgo, port_match_state(algo), 32, len(fl))
        if fill is not None:
            j0 = fill(j0)
        carried = train_state_from_jax(j0)
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        jstate = jstep(j0, jcl, jcu, jnp.asarray(IDX_L, jnp.int32),
                       jnp.asarray(IDX_U, jnp.int32),
                       jnp.asarray(epoch, jnp.int32))
    pstate = port_fixmatch_step(pcls, cfg_of, carried, epoch)[1]
    return jstate, pstate, carried


def port_fixmatch_step(pcls, cfg_of, carried, epoch: int = 1,
                       *overrides):
    """The port's step of :func:`fixmatch_steps` alone, from ``carried``,
    with ``overrides`` (``cfg_of(loader, *overrides)``): ``(algo, state
    after)``."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.train.convert import load_train_state
    (_, cl), (_, cu) = fixmatch_data()
    cfg = cfg_of(load_config, *overrides)
    algo = pcls(cfg, cfg.field_lengths, dtype=torch.float64, device="cpu")
    state = algo.init_state(seed=0)
    load_train_state(state, carried)
    fixed_views(algo, port=True)
    algo.make_train_step()(state, cl, cu, torch.tensor(IDX_L),
                           torch.tensor(IDX_U), epoch)
    return algo, state


def assert_equal_tree(a, b, path="ckpt"):
    """Two checkpoint payloads are equal, tensors bitwise."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


FIX_CLI = ["--device", "cpu", "dataset=synthetic_dvm", "models=resnet18",
           "img_size=32", "synthetic_image_size=40", "batch_size=8",
           "unlabelled_ratio=3", "synthetic_labelled=8",
           "synthetic_unlabelled=24", "synthetic_val=8", "synthetic_test=8",
           "num_classes=4", "tabular_embedding_dim=32",
           "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
           "projection_dim=8", "enable_progress_bar=false"]
FIX_TRAIN = ["evaluate=True", "start_epoch=0", "checkpoint_every_n_epochs=1",
             "save_checkpoints=false", "test_and_eval=false",
             "lr_eval=1.0e-3"]

# the Lightning-level buffers of a reference checkpoint of each family
# (tools/export_torch_checkpoint.py)
_REF_BUFFERS = {
    "SimMatch": lambda ex: {"model.bank": ex["bank"],
                            "model.labels": ex["bank_labels"]},
    "CoMatch": lambda ex: {
        "model.queue_s": ex["queue_s"], "model.probs_u": ex["probs_u"],
        "model.queue_ptr_s": torch.tensor([ex["ptr_s"]]),
        "model.queue_w": ex["queue_w"], "model.probs_xu": ex["probs_xu"],
        "model.queue_ptr_w": torch.tensor([ex["ptr_w"]])},
    "FreeMatch": lambda ex: {}}


def reference_ckpt(payload: dict, algorithm: str, path) -> None:
    """A port checkpoint's weights and buffers in the reference's
    Lightning layout of the FixMatch families: the student under
    ``model.main.`` (the multimodal net's ``model.`` prefix dropped), the
    teacher under ``model.ema.``, the family's buffers and the DA ring
    under their registered names."""
    sd = {}
    for k, v in payload["net"].items():
        sd["model.main." + (k[len("model."):] if k.startswith("model.")
                            else k)] = v
    sd.update({"model.ema." + k: v for k, v in payload["ema"].items()})
    sd.update(_REF_BUFFERS[algorithm](payload["extra"]))
    if payload["da"] is not None:
        sd["model.DA_queue"] = payload["da"]["queue"]
        sd["model.DA_ptr"] = torch.tensor([payload["da"]["ptr"]])
    torch.save({"state_dict": sd}, path)


@contextlib.contextmanager
def first_checkpoint_kept(directory):
    """Inside, the first ``checkpoint_last`` a training run writes (after
    its first epoch, with ``checkpoint_every_n_epochs=1``) is written to
    ``directory`` as well, with its config: the checkpoint a run that
    stopped there would resume from. Later epochs overwrite only the
    run's own."""
    from stil_tta_torch.train import checkpoint
    real = checkpoint.save_checkpoint

    def save(logdir, state, config=None, name="best"):
        path = real(logdir, state, config, name)
        if name == "checkpoint_last" and not (Path(directory)
                                              / name).exists():
            real(directory, state, config, name)
        return path

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "save_checkpoint", save)
        yield


def cli_resume_exact(name: str, tmp_path, *extra) -> dict:
    """``python -m stil_tta_torch.run`` on the CPU at test size: two
    epochs straight through equal bitwise the same run's first-epoch
    checkpoint resumed for the second (net, teacher, Adam, buffers,
    generators, sums). Returns the resumed run's last checkpoint; the
    runs' directories are removed."""
    from stil_tta_torch import run as port_run
    base = ["--config-name", name] + FIX_CLI + FIX_TRAIN + list(extra)
    with first_checkpoint_kept(tmp_path / "b"):
        assert port_run.main(base + ["max_epochs=2",
                                     f"logdir={tmp_path / 'a'}"]) == 0
    assert port_run.main([
        "--config-name", name, "--device", "cpu", "resume_training=True",
        f"checkpoint={tmp_path / 'b' / 'checkpoint_last'}", "max_epochs=2",
        f"logdir={tmp_path / 'c'}"]) == 0
    straight = torch.load(tmp_path / "a" / "checkpoint_last",
                          weights_only=True)
    resumed = torch.load(tmp_path / "c" / "checkpoint_last",
                         weights_only=True)
    assert straight["step"] == resumed["step"] == 8
    assert_equal_tree(straight, resumed)
    # the checkpoints take up to 600 MB: free them
    for part in ("a", "b", "c"):
        shutil.rmtree(tmp_path / part)
    return resumed


def cli_train_resume_test(name: str, tmp_path, *extra) -> dict:
    """:func:`cli_resume_exact` for a FixMatch family (a teacher and
    buffers); then the test entry point with BN-adapt on the resumed
    run's weights written in the reference's checkpoint layout, which
    loads strictly, and ``Predictor`` on those weights. Returns the
    resumed run's last checkpoint."""
    from stil_tta_torch import run as port_run
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.test import build_algo, load_test_split
    resumed = cli_resume_exact(name, tmp_path, *extra)
    assert resumed["ema"] is not None and resumed["extra"]

    cfg = load_config(name, FIX_CLI[2:] + list(extra))
    ckpt = tmp_path / "reference.ckpt"
    reference_ckpt(resumed, cfg.algorithm_name, ckpt)
    cfg.checkpoint = str(ckpt)
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu",
                      dtype=torch.float32)
    assert_equal_tree(algo.net.state_dict(), resumed["net"])
    # Predictor serves the (logits, emb) nets as their eval step scores
    cache = DeviceCache(src, device="cpu").as_dict()
    want = algo.make_eval_step()(cache, torch.arange(len(src)))["prob_m"]
    got = Predictor(algo, batch_size=len(src))(np.asarray(src.images),
                                               np.asarray(src.tabular))
    assert_close(got, want, 1e-6, 1e-7)
    assert port_run.main(["--config-name", name] + FIX_CLI + [
        "test=True", "evaluate=False", "tta=True", "tta_strategy=bn_adapt",
        f"checkpoint={ckpt}", f"logdir={tmp_path / 't'}"] + list(extra)) == 0
    assert (tmp_path / "t" / "test_results.csv").exists()
    ckpt.unlink()
    return resumed


def dp_port_job(rank: int, world: int, address: str, path: str) -> None:
    """One rank of the port's side of ``tests/test_torch_parallel_jax.py``,
    run in a process of its own (``python -c "from tests.torch_parity
    import dp_port_job; dp_port_job(rank, world, address, path)"``): the
    job written to ``path`` (a BatchNorm forward and backward, a STiL
    train step, ``Predictor`` scores) on a ``world``-rank gloo mesh. Rank
    0 writes the results to ``path + ".out"``; each rank's digest of its
    net's state goes with them."""
    import hashlib

    import torch.distributed as dist

    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    from stil_tta_torch.parallel import (create_mesh, init_process_group,
                                         sharded)
    from stil_tta_torch.parallel.collectives import all_reduce_grads
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.convert import load_train_state

    torch.set_num_threads(1)
    init_process_group("cpu", rank, world, address)
    mesh = create_mesh()
    job = torch.load(path, weights_only=False)
    out = {}

    b = job["bn"]
    bn = BatchNorm2d(b["weight"].shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(b["weight"])
        bn.bias.copy_(b["bias"])
    x = b["x"].clone().requires_grad_()
    with mesh:
        y = sharded(bn, (x.shape[0],), x)
    (y * b["g"]).sum().backward()
    all_reduce_grads(mesh, [x, bn.weight, bn.bias])
    out["bn"] = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                 "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                 "running_var": bn.running_var}

    def stil(spec):
        cfg = load_config("config_dvm_STiL", spec["overrides"])
        cfg.field_lengths = list(spec["field_lengths"])
        cfg.repeat_ratio = spec["repeat_ratio"]
        algo = STiL(cfg, spec["field_lengths"], dtype=torch.float64,
                    device="cpu")
        for layer in algo.net.model.transformer:   # the fusion's dropout
            layer.drop_path = layer.mlp.drop = 0.0
            layer.attn.attn_drop = layer.attn.proj_drop = 0.0
        state = algo.init_state(seed=0)
        load_train_state(state, spec["carried"])
        return algo, state

    s = job["step"]
    algo, state = stil(s)
    with mesh:
        algo.make_train_step()(state, s["cl"], s["cu"],
                               torch.arange(s["b_l"]), torch.arange(s["b_u"]),
                               s["epoch"], mask_rand=s["mask"])
    digest = hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in state.net.state_dict().values()))
    digests = [None] * world
    dist.all_gather_object(digests, digest.hexdigest())
    out["step"] = {"state": state, "digests": digests}

    p = job["serve"]
    algo, _ = stil(p)
    out["serve"] = Predictor(algo, p["batch_size"], mesh=mesh)(
        p["images"], p["tabular"])
    if rank == 0:
        torch.save(out, path + ".out")
    dist.destroy_process_group()
