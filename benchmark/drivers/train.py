"""Training traffic: STiL trained through the port's epoch body.

Set-up makes the splits and the weights on the device from the seed,
builds the algorithm, and runs the run's first three steps through the
window's own calls (one eager step, then the first dispatch of two rows:
its eager warm-up step and one replay of the step it captures), keeping
what the check compares: each step's loss, the first gradient (read
from Adam's first moment), the parameters' change after the third step.
One whole validation batch drawn from the seed is scored by the eval
step that ``run_validation`` drives before the first step and again
after the third (which warms the eval shapes); both outputs are kept.

The window then runs ``evaluate``'s epoch body from epoch ``start_epoch
+ epoch_offset``: the learning rate and the epoch's gates, the samplers
``evaluate`` seeds, the dispatcher over ``chunk_indices`` blocks of
``steps_per_dispatch``, the rest of the epoch as single steps, the epoch
end and ``run_validation`` over the validation split, in whole
dispatches and whole steps until ``--seconds`` have passed. No
checkpoint is written.

The check frees the program's state and follows the three steps with
the plain reference from the same weights, rows and random draws, and
scores the kept validation batch from the benchmark's weights and from
the reference's own weights after its three steps.
"""

from __future__ import annotations

import copy
import gc
import json
import sys

import numpy as np
import torch

import counts
import inputs
import system
from reference import compare, nets
from reference.stil import Trainer, eval_probs


class Recorder:
    """A train step that keeps the epoch's loss sum after each eager
    call while ``on`` (never inside a CUDA graph capture)."""

    def __init__(self, step, state):
        self.step, self.state, self.on, self.sums = step, state, True, []

    def __call__(self, *args, **kwargs):
        out = self.step(*args, **kwargs)
        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        if self.on and not capturing:
            self.sums.append(self.state.log_sums["loss"].detach().clone())
        return out


def _rows(rng: np.random.RandomState, n_steps: int, n: int, b: int):
    """Index rows for ``n_steps`` steps, each of ``b`` distinct rows."""
    return np.stack([rng.choice(n, b, replace=False)
                     for _ in range(n_steps)]).astype(np.int32)


def _rng_state(device):
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(device, st) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(st, device)
    else:
        torch.set_rng_state(st)


def prepare(run) -> dict:
    from stil_tta_torch.data.loader import EpochSampler
    from stil_tta_torch.train import optim
    from stil_tta_torch.train.evaluate import apply_batch_limit
    from stil_tta_torch.train.multistep import make_dispatcher
    conf, mix = run.cell.config, run.cell.mix
    dev = torch.device(run.device)
    cfg = system.port_config(conf, run.seed)
    sizes = conf["splits"]
    g = inputs.generator(run.seed, "train", dev)
    cache_l = inputs.make_split(sizes["labelled"], conf["cfg"], g, True, True)
    cache_u = inputs.make_split(sizes["unlabelled"], conf["cfg"], g, False,
                                False)
    cache_val = inputs.make_split(sizes["val"], conf["cfg"],
                                  inputs.generator(run.seed, "val", dev),
                                  True, True)
    weights = system.make_weights(conf, run.seed, dev)
    run.phase("inputs and weights")
    # the derivations evaluate makes (trainers/evaluate.py:83-88)
    l_batch, u_batch = system.split_sizes(cfg)
    ur = int(cfg.unlabelled_ratio)
    cfg.num_classes = int(conf["cfg"]["num_classes"])
    cfg.repeat_ratio = max(sizes["unlabelled"] // (ur * sizes["labelled"])
                           - 1, 1)
    steps = apply_batch_limit(EpochSampler(sizes["unlabelled"], u_batch,
                                           drop_last=True).steps_per_epoch(),
                              cfg.limit_train_batches)
    cfg.dataset_length = steps
    algo, state = system.build_algo(cfg, conf, weights, dev, run.seed,
                                    train=True)
    state.generator.manual_seed(inputs.stream_seed(run.seed, "views"))
    run.phase("algorithm and train state")
    step = Recorder(algo.make_train_step(), state)
    dispatch, why = make_dispatcher(cfg, algo, step)
    epoch0 = int(cfg.start_epoch) + int(mix["epoch_offset"])
    lr = optim.scheduled_lr(cfg, epoch0)
    optim.set_learning_rate(state.optimizer, lr)
    algo.set_epoch(epoch0)

    # one whole validation batch drawn from the seed, scored by the eval
    # step from the benchmark's weights, before any step
    eval_step = algo.make_eval_step()
    batch = int(cfg.batch_size)
    at = np.random.RandomState(run.seed % 2 ** 31 + 7).randint(
        max(sizes["val"] // batch, 1)) * batch
    idx = torch.arange(at, at + batch, device=dev)
    probe = {"idx": idx, "val0": val_probs(eval_step, cache_val, idx)}
    run.sync()
    run.phase("first eval batch")

    # the run's first three steps, on rows that all differ
    rng = np.random.RandomState(run.seed % 2 ** 31)
    il = torch.from_numpy(_rows(rng, 3, sizes["labelled"], l_batch)).to(dev)
    iu = torch.from_numpy(_rows(rng, 3, sizes["unlabelled"], u_batch)).to(dev)
    draws = {"views": state.generator.get_state(), "rng": _rng_state(dev)}
    loss0 = state.log_sums["loss"].detach().clone()
    step(state, cache_l, cache_u, il[0], iu[0], epoch0)
    run.sync()
    run.phase("first step (eager)")
    names = [k for k, _ in state.net.named_parameters()]
    params = dict(state.net.named_parameters())
    b1 = state.optimizer.param_groups[0]["betas"][0]
    # a leaf Adam holds no moment for has not been stepped: gradient 0
    grad1 = compare.norms({
        k: state.optimizer.state.get(params[k], {}).get(
            "exp_avg", torch.zeros_like(params[k])) / (1 - b1)
        for k in names})
    dispatch(state, [(cache_l, cache_u, il[i], iu[i]) for i in (1, 2)],
             epoch0)
    run.sync()
    run.phase("first dispatch (capture)")
    sums = [float(loss0)] + [float(s) for s in step.sums[:2]] + \
        [float(state.log_sums["loss"])]
    losses = [b - a for a, b in zip(sums, sums[1:])]
    change3 = compare.norms({k: params[k].detach() - weights[k]
                             for k in names})
    step.on = False

    # the same batch after the third step, which warms the eval shapes
    probe["val"] = val_probs(eval_step, cache_val, idx)
    run.sync()
    run.phase("eval batch after three steps")
    m = conf["cfg"]
    val_flops = (-(-sizes["val"] // batch)
                 * counts.stil_forward_flops(batch, m))
    return {"cfg": cfg, "algo": algo, "state": state, "dispatch": dispatch,
            "step_flops": counts.stil_step_flops(batch, m),
            "val_flops": val_flops,
            "route": dispatch.route, "route_why": why, "step": step.step,
            "eval_step": eval_step, "caches": (cache_l, cache_u, cache_val),
            "weights": weights, "epoch0": epoch0, "lr": lr, "steps": steps,
            "batches": (l_batch, u_batch), "rows": (il, iu), "draws": draws,
            "probe": probe, "program": {"losses": losses, "grad1": grad1,
                                        "change3": change3}}


def val_probs(eval_step, cache_val: dict, idx) -> dict:
    """The eval step's three heads' probabilities on the rows ``idx``."""
    out = eval_step(cache_val, idx, torch.ones(idx.shape[0],
                                               device=idx.device))
    return {k: out[f"prob_{k}"].float().clone() for k in ("m", "i", "t")}


def make_samplers(run, ctx, epoch: int):
    """The samplers ``evaluate`` seeds for ``epoch``."""
    from stil_tta_torch.data.loader import CyclingSampler, EpochSampler
    sizes = run.cell.config["splits"]
    l_batch, u_batch = ctx["batches"]
    seed0 = run.seed % 2 ** 31
    u = EpochSampler(sizes["unlabelled"], u_batch, shuffle=True,
                     drop_last=True, seed=seed0 + 100003 * epoch)
    lab = CyclingSampler(sizes["labelled"], l_batch,
                         seed=seed0 + 100003 * epoch + 1)
    return lab, u


def validate(run, ctx) -> None:
    """``run_validation`` of the validation split."""
    from stil_tta_torch.train.evaluate import run_validation
    cfg = ctx["cfg"]
    run_validation(ctx["eval_step"], ctx["caches"][2], int(cfg.batch_size),
                   int(cfg.num_classes), limit_batches=cfg.limit_val_batches)


def epoch_body(run, ctx, epoch: int, over) -> bool:
    """``evaluate``'s epoch body for ``epoch``, in whole dispatches and
    whole steps while ``over()`` is false; the epoch end and the
    validation when the epoch ran whole. Returns whether it did."""
    from stil_tta_torch.train import optim
    from stil_tta_torch.train.multistep import chunk_indices
    cfg, state, algo = ctx["cfg"], ctx["state"], ctx["algo"]
    cache_l, cache_u, _ = ctx["caches"]
    dev = torch.device(run.device)
    spd = int(cfg.steps_per_dispatch)
    kind = "steps_graphed" if ctx["route"] == "graph" else "steps_eager"
    optim.set_learning_rate(state.optimizer, optim.scheduled_lr(cfg, epoch))
    algo.set_epoch(epoch)
    l_sampler, u_sampler = make_samplers(run, ctx, epoch)
    pairs = [(l_sampler.next()[0], idx_u)
             for idx_u, _ in u_sampler.epoch()][:ctx["steps"]]
    blocks, tail = chunk_indices(pairs, spd)
    for il_k, iu_k in blocks:
        if over():
            return False
        with run.span("dispatch"):
            il_k = torch.from_numpy(il_k).to(dev)
            iu_k = torch.from_numpy(iu_k).to(dev)
            ctx["dispatch"](state, [(cache_l, cache_u, il_k[i], iu_k[i])
                                    for i in range(spd)], epoch)
        run.add(kind, spd)
        run.add("flops", spd * ctx["step_flops"])
    for idx_l, idx_u in tail:
        if over():
            return False
        with run.span("eager_step"):
            ctx["step"](state, cache_l, cache_u,
                        torch.from_numpy(idx_l).to(dev),
                        torch.from_numpy(idx_u).to(dev), epoch)
        run.add("steps_eager")
        run.add("flops", ctx["step_flops"])
    with run.span("epoch_end"):
        algo.epoch_end(state)
    with run.span("validation"):
        validate(run, ctx)
    run.add("validations")
    run.add("flops", ctx["val_flops"])
    return True


def measure(run, ctx) -> None:
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    batch = int(ctx["cfg"].batch_size)
    launches0 = (bn_stats.launches, bn_bwd_reduce.launches)
    epoch = ctx["epoch0"]
    with run.window():
        while not run.over() and epoch_body(run, ctx, epoch, run.over):
            epoch += 1
    steps = run.counts.get("steps_graphed", 0) + run.counts.get(
        "steps_eager", 0)
    run.counts["steps"] = steps
    run.counts["samples"] = steps * batch
    run.counts["bn_stats_launches"] = bn_stats.launches - launches0[0]
    run.counts["bn_bwd_reduce_launches"] = bn_bwd_reduce.launches - \
        launches0[1]
    run.counts["bn_passes_batch"] = batch
    run.attempted = int(steps)
    run.values["train_samples_per_s"] = run.counts["samples"] / run.window_s


def free_program(run, ctx) -> None:
    """Drop the program's state and graph, keeping the inputs."""
    for k in ("algo", "state", "dispatch", "step", "eval_step"):
        ctx.pop(k, None)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def reference_readings(run, ctx, mode: str) -> dict:
    """The reference (``mode`` ``f32``) or the control (``fp8``) on the
    kept validation batch from the benchmark's weights, through the three
    steps, then on that batch again from its own weights."""
    conf = run.cell.config
    m = conf["cfg"]
    dev = torch.device(run.device)
    cache_l, cache_u, cache_val = ctx["caches"]
    net = nets.build(m, dev, mode, ctx["weights"])
    idx = ctx["probe"]["idx"]
    images = cache_val["images"].index_select(0, idx)
    tabular = cache_val["tabular"].index_select(0, idx)
    with torch.no_grad():
        val0 = eval_probs(net, m, images, tabular)
    ema = copy.deepcopy(net.model)
    tr = Trainer(m, net, ema, ctx["lr"])
    gen = torch.Generator(device=dev)
    gen.set_state(ctx["draws"]["views"])
    _set_rng_state(dev, ctx["draws"]["rng"])
    use_pseudo = float(ctx["epoch0"] > int(m["start_epoch"]))
    il, iu = ctx["rows"]
    names = [k for k, _ in net.named_parameters()]
    params = dict(net.named_parameters())
    losses, grad1 = [], None
    for i in range(3):
        losses.append(float(tr.step(cache_l, cache_u, il[i], iu[i], gen,
                                    use_pseudo)))
        if i == 0:
            grad1 = compare.norms({k: params[k].grad for k in names})
    change3 = compare.norms({k: params[k].detach() - ctx["weights"][k]
                             for k in names})
    del tr, ema
    with torch.no_grad():
        val = eval_probs(net, m, images, tabular)
    return {"losses": losses, "grad1": grad1, "change3": change3,
            "val0": val0, "val": val}


def readings(prog: dict, ref: dict, probe: dict) -> dict:
    """The numbers of one side against the reference. ``grad_gap`` and
    ``change_gap`` (the worst leaf's) are reported, not compared: the
    early layers' gradient norms move by a fifth and more under bfloat16's
    rounding, which the float32 path does not show (PERF.md §6), so the
    median leaf's stands for them. ``val0_*``: the validation batch from
    the benchmark's weights on both sides; ``val_*``: after three steps,
    each side from its own weights."""
    keep = compare.leaves_that_count(ref["grad1"])
    return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": compare.worst_leaf_gap(prog["grad1"], ref["grad1"],
                                               keep),
            "grad_median_gap": compare.median_leaf_gap(
                prog["grad1"], ref["grad1"], keep),
            "change_gap": compare.worst_leaf_gap(
                prog["change3"], ref["change3"], keep),
            "change_median_gap": compare.median_leaf_gap(
                prog["change3"], ref["change3"], keep),
            **{f"{v}_{name}": max(gap(probe[v][k], ref[v][k])
                                  for k in ("m", "i", "t"))
               for v in ("val0", "val")
               for name, gap in (("prob_gap", compare.prob_gap),
                                 ("kl", compare.kl_gap),
                                 ("flip", compare.flip_share))}}


def check(run, ctx, control: bool = False) -> dict:
    """Free the program, run the reference, and return the program's
    readings; with ``control`` also the control's (the reference in
    float8 in the program's place)."""
    free_program(run, ctx)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_readings(run, ctx, "f32")
    out = {"program": readings(ctx["program"], ref, ctx["probe"])}
    if control:
        low = reference_readings(run, ctx, "fp8")
        out["control"] = readings(low, ref, low)
    return out


def run(run) -> None:
    ctx = prepare(run)
    measure(run, ctx)
    if run.device != "cpu":
        run.memory_peak = torch.cuda.max_memory_allocated(
            torch.device(run.device))
    readings = check(run, ctx)["program"]
    print(f"readings {json.dumps(readings)}", file=sys.stderr)
    for name, value in readings.items():
        if name in run.cell.workload["limits"]:
            run.check(name, value)


def probe(run, ctx) -> None:
    """What the check reads, without a timed window: nothing more, since
    set-up keeps all of it."""
