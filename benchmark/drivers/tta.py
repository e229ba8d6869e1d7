"""Test-time adaptation traffic: the TTA fork's workflow on shifted
splits, through the port's ``tta.tent.adapt`` and ``run_validation``.

Set-up makes ``splits`` shifted test splits of ``split_rows`` rows on the
device from the seed (each its own colour gain and offset and its own
shift of the continuous columns' means), loads the benchmark's weights
into the algorithm's net, keeps a device copy of every BatchNorm's
statistics and affine parameters, and warms the cell's shapes with one
split (adapt and score), restoring the net after it.

The window cycles through the splits: the BatchNorm state restored in
place from the copy, ``adapt`` (the configuration's ``tta_strategy``:
the statistics pass, then Tent's entropy steps), then ``run_validation``
at the configuration's batch size, until ``--seconds`` have passed.
For one split occurrence drawn from the seed, the adapted BatchNorm
state (statistics and affine parameters), the first entropy step's
gradients and the scored probabilities are kept.

The check frees the program and adapts that split with the plain
reference from the same weights: the statistics and the affine
parameters' change over ``adapt`` are compared with the reference's,
and the program's scores with the reference's scores from the
program's own adapted state.
"""

from __future__ import annotations

import gc
import json
import sys

import numpy as np
import torch

import counts
import inputs
import system
from reference import compare, nets
from reference.stil import bn_state, eval_probs, tent


class Scores:
    """An eval step that keeps every batch's probabilities while ``on``."""

    def __init__(self, step):
        self.step, self.on, self.kept = step, False, []

    def __call__(self, cache, idx, w=None):
        out = self.step(cache, idx, w)
        if self.on:
            self.kept.append((w, {k: out[f"prob_{k}"].float()
                                  for k in ("m", "i", "t")}))
        return out


def _bn_tensors(net) -> dict:
    """The port net's BatchNorm tensors by name (statistics, counters,
    affine parameters)."""
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    out = {}
    for name, m in net.named_modules():
        if isinstance(m, BatchNorm2d):
            for k in ("running_mean", "running_var", "num_batches_tracked",
                      "weight", "bias"):
                out[f"{name}.{k}"] = getattr(m, k)
    return out


class FirstStep:
    """The port's Tent optimizer factory, wrapped: while ``on``, the
    optimizer it builds keeps its first step's gradients (read from
    Adam's first moment) by BatchNorm parameter name in ``grads``."""

    def __init__(self, build, names):
        self.build, self.names, self.on, self.grads = build, names, False, {}

    def __call__(self, params, *args, **kwargs):
        params = list(params)
        opt = self.build(params, *args, **kwargs)
        if not self.on:
            return opt
        step, grads = opt.step, self.grads
        b1 = opt.param_groups[0]["betas"][0]

        def first(*a, **k):
            out = step(*a, **k)
            if not grads:
                grads.update((self.names[id(p)],
                              opt.state[p]["exp_avg"].detach() / (1 - b1))
                             for p in params)
            return out
        opt.step = first
        return opt


def prepare(run) -> dict:
    from stil_tta_torch.tta import tent as tent_mod
    from stil_tta_torch.tta.tent import adapt
    conf, mix = run.cell.config, run.cell.mix
    dev = torch.device(run.device)
    cfg = system.port_config(conf, run.seed)
    cfg.num_classes = int(conf["cfg"]["num_classes"])
    m = conf["cfg"]
    base = inputs.make_split(int(mix["split_rows"]), m,
                             inputs.generator(run.seed, "test", dev), True,
                             False)
    g = inputs.generator(run.seed, "shift", dev)
    splits = [inputs.shift_split(base, m, g) for _ in range(mix["splits"])]
    del base
    weights = system.make_weights(conf, run.seed, dev)
    run.phase("inputs and weights")
    algo, _ = system.build_algo(cfg, conf, weights, dev, run.seed,
                                train=False)
    names = {id(p): k for k, p in tent_mod.bn_parameters(algo.net)}
    build = getattr(tent_mod.build_optimizer, "build",
                    tent_mod.build_optimizer)
    tent_mod.build_optimizer = FirstStep(build, names)
    live = _bn_tensors(algo.net)
    saved = {k: v.detach().clone() for k, v in live.items()}
    scores = Scores(algo.make_eval_step())
    ctx = {"cfg": cfg, "algo": algo, "splits": splits, "weights": weights,
           "live": live, "saved": saved, "scores": scores, "adapt": adapt}
    run.phase("algorithm")
    score_split(run, ctx, 0)     # the warm-up: one split, then restored
    restore(ctx)
    run.sync()
    run.phase("warm-up split")
    return ctx


@torch.no_grad()
def restore(ctx) -> None:
    keys = list(ctx["live"])
    torch._foreach_copy_([ctx["live"][k] for k in keys],
                         [ctx["saved"][k] for k in keys])


def score_split(run, ctx, i: int) -> None:
    """Adapt on split ``i`` and score it (the window's unit of work)."""
    from stil_tta_torch.train.evaluate import run_validation
    cfg, algo = ctx["cfg"], ctx["algo"]
    with run.span("adapt", sync=True):
        ctx["adapt"](cfg, algo, ctx["splits"][i])
    if ctx.get("keep_bn"):
        ctx["bn_after"] = {k: v.detach().clone()
                           for k, v in ctx["live"].items()
                           if "num_batches" not in k}
    with run.span("score"):
        run_validation(ctx["scores"], ctx["splits"][i], int(cfg.batch_size),
                       int(cfg.num_classes), prefix="test")


def measure(run, ctx) -> None:
    from stil_tta_torch.ops.batch_norm import bn_stats
    cfg = ctx["cfg"]
    m = run.cell.config["cfg"]
    n_splits = len(ctx["splits"])
    rows = int(ctx["splits"][0]["labels"].shape[0])
    batch = int(cfg.batch_size)
    n_batches = -(-rows // batch)
    split_flops = n_batches * (counts.stats_pass_flops(batch, m)
                               + int(cfg.tta_steps)
                               * counts.tent_step_flops(batch, m)
                               + counts.score_flops(batch, m))
    keep_at = int(np.random.RandomState(run.seed % 2 ** 31 + 11).randint(
        n_splits))
    from stil_tta_torch.tta import tent as tent_mod
    scores = ctx["scores"]
    first_step = tent_mod.build_optimizer
    first_step.grads.clear()
    launches0 = bn_stats.launches
    done = 0
    with run.window():
        # the kept occurrence always runs, however short the window
        while not run.over() or done <= keep_at:
            i = done % n_splits
            with run.span("restore"):
                restore(ctx)
            first = done == keep_at
            ctx["keep_bn"] = scores.on = first_step.on = first
            score_split(run, ctx, i)
            ctx["keep_bn"] = scores.on = first_step.on = False
            if first:
                ctx["kept_split"] = i
                ctx["tent_grad1"] = dict(first_step.grads)
            done += 1
            run.add("flops", split_flops)
    run.counts["splits"] = done
    run.counts["samples"] = done * rows
    run.counts["bn_stats_launches"] = bn_stats.launches - launches0
    run.counts["bn_passes_batch"] = batch
    run.attempted = done
    run.values["tta_samples_per_s"] = run.counts["samples"] / run.window_s


def reference_readings(run, ctx, mode: str) -> dict:
    """The reference (``f32``) or the control (``fp8``) adapting the kept
    split from the benchmark's weights: the adapted BatchNorm state, the
    first entropy step's gradients, and (the control) its scores."""
    m = run.cell.config["cfg"]
    dev = torch.device(run.device)
    cache = ctx["splits"][ctx["kept_split"]]
    net = nets.build(m, dev, mode, ctx["weights"])
    grads: dict = {}
    tent(net, m, cache, int(ctx["cfg"].batch_size), grads)
    out = {"bn": bn_state(net), "grad1": grads}
    if mode != "f32":
        out["probs"] = score(run, ctx, net)
    return out


def score(run, ctx, net) -> dict:
    """``net``'s three heads' probabilities over the kept split, in
    order, at the configuration's batch size."""
    m = run.cell.config["cfg"]
    cache = ctx["splits"][ctx["kept_split"]]
    n, batch = int(cache["labels"].shape[0]), int(ctx["cfg"].batch_size)
    probs = {k: [] for k in ("m", "i", "t")}
    for s in range(0, n, batch):
        j = torch.arange(s, min(s + batch, n), device=cache["labels"].device)
        out = eval_probs(net, m, cache["images"].index_select(0, j),
                         cache["tabular"].index_select(0, j))
        for k in probs:
            probs[k].append(out[k])
    return {k: torch.cat(v) for k, v in probs.items()}


def scores_from(run, ctx, bn: dict) -> dict:
    """The float32 reference's scores of the kept split from the
    benchmark's weights with the adapted BatchNorm state ``bn``."""
    net = nets.build(run.cell.config["cfg"], torch.device(run.device), "f32",
                     dict(ctx["weights"], **bn))
    return score(run, ctx, net)


def readings(side: dict, ref: dict, ref_scores: dict, weights: dict) -> dict:
    """``side``'s adapted statistics against the reference's from the
    same weights; its Tent update, by the first entropy step's gradients
    and by the BatchNorm affine parameters' change over ``adapt``, against
    the reference's; and its scores against the reference's scores from
    ``side``'s own adapted state (``ref_scores``)."""
    stats = {k: v for k, v in ref["bn"].items() if "running" in k}
    affine = [k for k in ref["bn"] if k.endswith((".weight", ".bias"))]
    change_ref = {k: ref["bn"][k] - weights[k] for k in affine}
    change_side = {k: side["bn"][k] - weights[k] for k in affine}
    g_ref = ref["grad1"]
    # a side that took no entropy step has no gradient to read: zero
    g_side = {k: side["grad1"].get(k, torch.zeros_like(v))
              for k, v in g_ref.items()}
    return {
        "bn_stats_gap": compare.worst_diff(
            {k: side["bn"][k] for k in stats}, stats),
        "tent_grad_median_gap": compare.median_leaf_gap(
            compare.norms(g_side), compare.norms(g_ref)),
        "tent_change_median_gap": compare.median_leaf_gap(
            compare.norms(change_side), compare.norms(change_ref)),
        "score_kl": max(compare.kl_gap(side["probs"][k], ref_scores[k])
                        for k in ("m", "i", "t"))}


def check(run, ctx, control: bool = False) -> dict:
    """Free the program, run the reference, and return the program's
    readings (and with ``control`` the control's): the statistics and the
    Tent update from the same weights; the scores against the reference
    scoring from each side's own adapted state, since the adaptation is
    judged by itself."""
    kept = ctx["scores"].kept
    prog = {"bn": ctx["bn_after"], "grad1": ctx["tent_grad1"],
            "probs": {k: torch.cat([p[k][w > 0] for w, p in kept])
                      for k in ("m", "i", "t")}}
    for k in ("algo", "scores", "live", "saved", "adapt"):
        ctx.pop(k, None)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = ctx["weights"]
    ref = reference_readings(run, ctx, "f32")
    out = {"program": readings(prog, ref, scores_from(run, ctx, prog["bn"]),
                               w)}
    if control:
        low = reference_readings(run, ctx, "fp8")
        out["control"] = readings(low, ref, scores_from(run, ctx, low["bn"]),
                                  w)
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
    """What the check reads, without a timed window: the splits up to the
    kept occurrence."""
    seconds, run.seconds = run.seconds, 0.0
    measure(run, ctx)
    run.seconds = seconds
