#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Run from the root of the repository. It needs a CUDA card and fails
without one; it never runs on the CPU. Phases, each fatal on failure:

1. Device: name, count, and ``nvidia-smi`` name and power limit.
2. Build: ``csrc/bn_stats.cu``, ``csrc/bn_bwd_reduce.cu``,
   ``csrc/conv_chain.cu`` and ``csrc/conv_bwd_join.cu`` with ``nvcc`` for
   sm_90a, all compilers started together; build time and each
   compiler's register / shared-memory / spill report.
3. Kernels against plain: ``bn_stats`` and ``bn_bwd_reduce`` against
   their plain versions at every distinct (M, C) of ResNet-50's
   BatchNorms at batch 512 and 128x128, in bfloat16 and float32, and two
   launches bitwise equal; then the train-mode BN Function's gradients
   (dx, dweight, dbias) with the kernels against the plain Function on
   the stem's shape.
4. The test-time slice at full width: ``config_dvm_STiL
   dataset=synthetic_dvm num_classes=286 synthetic_test=2048
   batch_size=512 test=True tta=True tta_strategy=bn_adapt`` through
   ``train.test.test`` (ResNet-50, 4-layer tabular transformer at d=512,
   one fusion layer, seeded random weights), with the kernel's launch
   count, wall time and peak memory; then the same adaptation with the
   kernel and with the plain statistics side by side; then a profile of
   the adaptation, which must show one ``bn_stats`` kernel a launch (212)
   and no ``column_sums`` kernel.
5. Serving: ``Predictor`` at batch 512, samples/s.
6. Training at full width: ``config_dvm_STiL dataset=synthetic_dvm
   num_classes=286 batch_size=512 synthetic_labelled=512
   synthetic_unlabelled=3584 evaluate=True max_epochs=2 start_epoch=0
   strict_prototypes=false test_and_eval=true`` through
   ``train.evaluate.evaluate``: 8 steps an epoch of 64 labelled + 448
   unlabelled rows, the second epoch with the pseudo-label losses; the
   train, val and test logs, both kernels' launch counts (53 x 16 each),
   steps/s, samples/s and peak memory.
7. One train step with the kernels and one with the plain pair, from one
   state: loss, gradients, parameters and BN running statistics side by
   side.
8. Profile of one train step: device busy time against the host's clock,
   the shares of the two kernels and of BN's elementwise work, and the
   top kernels.
9. Timing: per shape, each kernel, its device-memory bound, the plain
   version and the library call that computes the same sums
   (``torch.batch_norm_stats``, ``torch.batch_norm_backward_reduce``;
   never called by the port), with the L2 cache flushed before every
   launch (and ``bn_stats`` also after a flush that only reads, which
   leaves no dirty lines in L2); ``bn_stats``'s plan beside each shape,
   its registers, shared memory and spills (the ``-Xptxas -v`` report),
   and its per-call floor (one row a block) beside ``x.add_(0)``.
10. TTA strategies at full width: ``test()`` with ``tta_strategy`` tent,
    eata and sar on the configuration of phase 4, each with its metrics,
    wall time and ``bn_stats`` launches (53 x 4, the stats phase); then
    ``adapt`` alone on fresh weights, with what it ran (steps, samples
    the filters kept, SAR's resets), its wall time, and a check that only
    the BatchNorm affine parameters and running statistics changed.
11. The conv+BN probe (``stil_tta_torch.tools.bench_conv_probe``) at
    M = 524,288, K = 256, N = 64, NJ = 256: ``conv_chain``,
    ``conv_chain_scratch`` and ``conv_bwd_join`` against their plain
    versions at that M and at a ragged M, two launches bitwise equal;
    then the probe's entry point (its own check, and every variant's
    slope time against the bound), the plain versions' times and the
    join's GEMM timed the same way, and each kernel's time and share of
    its bound beside its registers, shared memory and spills (the
    ``-Xptxas -v`` report) and its shared-memory plan.

Float32 convolutions and matmuls run in full float32 here (TF32 off), so
float32 comparisons are not blurred by TF32 rounding. The second-to-last
line is the kernels' JSON record and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BATCH, IMG = 512, 128
TOL = 1e-5                  # relative, of float32 sums over the same data
FN_TOL = 1e-2               # of max|dx|: one bfloat16 rounding is 2^-8
SOURCES = ("bn_stats", "bn_bwd_reduce", "conv_chain", "conv_bwd_join")
TEST_OVERRIDES = ["dataset=synthetic_dvm", "num_classes=286",
                  "synthetic_test=2048", "batch_size=512", "test=True",
                  "tta=True", "enable_progress_bar=false"]
# with random weights the head's entropies lie near ln 286, beyond the
# default margin (0.4 ln 286): at 1.0 EATA's and SAR's filters keep
# samples and their steps do work
TTA_MARGIN = "tta_e_margin_scale=1.0"
RAGGED = 29                 # rows the probe's ragged check leaves out
TRAIN_OVERRIDES = [
    "dataset=synthetic_dvm", "num_classes=286", "batch_size=512",
    "synthetic_labelled=512", "synthetic_unlabelled=3584",
    "synthetic_val=1024", "synthetic_test=1024", "evaluate=True",
    "max_epochs=2", "start_epoch=0", "strict_prototypes=false",
    "test_and_eval=true", "enable_progress_bar=false",
    "logdir=runs/chip_smoke_train",
]
TRAIN_STEPS = 16            # 2 epochs of 3584 // 448 steps
STEP_LR = 1e-4              # lr_eval, for the side-by-side step


def log(*args):
    print(*args, flush=True)


def resnet50_bn_shapes(device) -> list:
    """(M, C) of each of ResNet-50's BatchNorm inputs at BATCH and IMG,
    in forward order, read off the tower with forward hooks."""
    from stil_tta_torch.models.resnet import resnet50
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    tower = resnet50(dtype=torch.bfloat16).to(device).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append(
                    (BATCH * inp[0].shape[2] * inp[0].shape[3],
                     inp[0].shape[1])))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device=device))
    return seen


def time_ms(fn, x, buf, reps=50, flush=None) -> float:
    """Mean device time of ``fn(x)``, each call after an L2 flush (a
    write of ``buf``, or ``flush()``). A spin kernel first gives the card
    a head start, so the host queues every call before the card reaches
    them and the span holds no host time; the flushes' own span, measured
    the same way, is subtracted. The write leaves up to 50 MB of dirty
    lines in L2, which the timed call's reads evict to device memory."""
    def span(body) -> float:
        body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms of spinning
        start.record()
        for _ in range(reps):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    flush = flush or buf.zero_
    alone = span(flush)
    both = span(lambda: (flush(), fn(x)))
    return (both - alone) / reps


def check_bwd_kernel(per_forward, gen, dev) -> float:
    """``bn_bwd_reduce`` against its plain version at every shape, in
    bfloat16 and float32, two launches bitwise equal; returns the largest
    absolute error."""
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain)
    max_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in per_forward:
            x = (torch.randn(m, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            dy = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            xf = x.float()
            mean = xf.mean(0)
            inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
            s, q = bn_bwd_reduce(x, dy, mean, inv)
            s2, q2 = bn_bwd_reduce(x, dy, mean, inv)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(s, s2) and torch.equal(q, q2))
            ps, pq = bn_bwd_reduce_plain(x, dy, mean, inv)
            dyf = dy.float()
            scale_s = dyf.abs().sum(0, keepdim=True)
            scale_q = (dyf * ((xf - mean) * inv)).abs().sum(0, keepdim=True)
            rel_s = float(((s - ps).abs() / scale_s).max())
            rel_q = float(((q - pq).abs() / scale_q).max())
            abs_err = max(float((s - ps).abs().max()),
                          float((q - pq).abs().max()))
            max_abs = max(max_abs, abs_err)
            log(f"[bwd] {str(dtype)[6:]:8s} M={m:>9,d} C={c:>5d} max rel "
                f"err of sum|dy| {rel_s:.2e}, of sum|dy x_hat| {rel_q:.2e} "
                f"(tol {TOL:.0e}) abs {abs_err:.3e} bitwise-repeat "
                f"{bitwise}")
            if not (bitwise and max(rel_s, rel_q) < TOL):
                raise SystemExit(f"bn_bwd_reduce disagrees at {(m, c, dtype)}")
            del x, dy, xf, dyf
    return max_abs


def check_bn_function(gen, dev) -> None:
    """The train-mode BN Function's gradients with the kernel pair
    against the plain pair, at the stem's shape in bfloat16.

    dy is drawn as ``k * x_hat + 0.5 + noise`` per channel, so that the
    sums (dbias = sum dy, dweight = sum dy x_hat) are of order M and the
    terms they put into dx are of the order of dy itself: sums that were
    zero or of the wrong sign would move dx by about max|dx|."""
    from stil_tta_torch.ops.batch_norm import (BNTrain, bn_bwd_reduce,
                                               bn_bwd_reduce_plain, bn_stats,
                                               bn_stats_plain)
    n, c, hw = BATCH, 64, IMG // 2
    cl = torch.channels_last
    x = (torch.randn(n, c, hw, hw, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16).contiguous(memory_format=cl)
    xf = x.float()
    mu = xf.mean((0, 2, 3), keepdim=True)
    sd = (xf.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5).sqrt()
    k = torch.rand(1, c, 1, 1, generator=gen, device=dev) + 0.5
    dy = (k * (xf - mu) / sd + 0.5
          + torch.randn(n, c, hw, hw, generator=gen, device=dev)).to(
        torch.bfloat16).contiguous(memory_format=cl)
    del xf
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev)
    grads = {}
    for name, fns in (("kernel", (bn_stats, bn_bwd_reduce)),
                      ("plain", (bn_stats_plain, bn_bwd_reduce_plain))):
        xr = x.detach().requires_grad_()
        wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
        y, _, _ = BNTrain.apply(xr, wr, br, 1e-5, *fns)
        y.backward(dy)
        grads[name] = (xr.grad.float(), wr.grad, br.grad)
    (dxk, dwk, dbk), (dxp, dwp, dbp) = grads["kernel"], grads["plain"]
    rel_dx = float((dxk - dxp).abs().max() / dxp.abs().max())
    rel_dw = float(((dwk - dwp).abs() / dwp.abs().clamp_min(1e-30)).max())
    rel_db = float(((dbk - dbp).abs() / dbp.abs().clamp_min(1e-30)).max())
    m = n * hw * hw
    log(f"[bwd] BN Function at {(n, c, hw, hw)} bf16, kernels vs plain: "
        f"max|d dx|/max|dx| {rel_dx:.2e} (tol {FN_TOL:.0e}); dweight max "
        f"rel {rel_dw:.2e}, dbias max rel {rel_db:.2e} (tol {TOL:.0e}); "
        f"reduction terms against max|dy|: sum dy/M "
        f"{float(dbp.abs().min()) / m:.3f}-{float(dbp.abs().max()) / m:.3f}, "
        f"sum dy x_hat/M {float(dwp.abs().min()) / m:.3f}-"
        f"{float(dwp.abs().max()) / m:.3f}, max|dy| "
        f"{float(dy.abs().max()):.3f}")
    if rel_dx > FN_TOL:
        raise SystemExit("BN Function: kernel and plain dx disagree")
    if max(rel_dw, rel_db) > TOL:
        raise SystemExit("BN Function: kernel and plain dweight or dbias "
                         "disagree")


def train_full_width() -> tuple:
    """Phase 6: ``evaluate`` at full width; returns the config and the
    kernels' launch counts of the run."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import BNTrain, bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.evaluate import evaluate
    cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES)
    logdir = Path(cfg.logdir)
    shutil.rmtree(logdir, ignore_errors=True)
    log(f"[train] {cfg.model} img {cfg.img_size} tabular "
        f"{cfg.tabular_transformer_num_layers}x{cfg.tabular_embedding_dim} "
        f"fusion {cfg.multimodal_transformer_num_layers}x"
        f"{cfg.multimodal_embedding_dim} classes {cfg.num_classes} batch "
        f"{cfg.batch_size} (unlabelled_ratio {cfg.unlabelled_ratio}) "
        f"labelled {cfg.synthetic_labelled} unlabelled "
        f"{cfg.synthetic_unlabelled} epochs {cfg.max_epochs}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bn_stats.launches = bn_bwd_reduce.launches = 0
    BNTrain.dy_copies = 0
    t0 = time.perf_counter()
    results = evaluate(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bn_stats": bn_stats.launches,
                "bn_bwd_reduce": bn_bwd_reduce.launches}
    dy_copies = BNTrain.dy_copies
    peak = torch.cuda.max_memory_allocated()
    records = [json.loads(line) for line in
               (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "multimodal.train.loss" in r]
    val = [r for r in records if "eval.val.acc" in r]
    for r in train:
        log(f"[train] epoch {r['_step']} train {json.dumps(r)}")
    for r in val:
        log(f"[train] epoch {r['_step']} val {json.dumps(r)}")
    log(f"[train] results {json.dumps(results)}")
    sps = train[-1]["multimodal.train.samples_per_sec"]
    log(f"[train] second epoch: {sps / int(cfg.batch_size):.3f} steps/s, "
        f"{sps:.1f} samples/s (8 steps and epoch_end, host clock); whole "
        f"run {wall:.1f} s (data synthesis, weight init, validation, "
        f"checkpoints, test); peak memory {peak / 2**30:.3f} GiB")
    log(f"[train] launches {launches} (53 x {TRAIN_STEPS} = "
        f"{53 * TRAIN_STEPS} each); dy copied to channels_last in "
        f"{dy_copies} of {launches['bn_bwd_reduce']} BN backwards")
    if any(n != 53 * TRAIN_STEPS for n in launches.values()):
        raise SystemExit("a kernel's launch count is off the training path")
    values = [v for r in train + val for k, v in r.items()
              if k != "_step" and isinstance(v, (int, float))]
    values += list(results.values())
    if len(train) != 2 or not all(math.isfinite(v) for v in values):
        raise SystemExit("non-finite or missing training logs or metrics")
    return cfg, launches


def _clone(named) -> dict:
    return {k: t.detach().float().clone() for k, t in named}


def train_step_kernel_vs_plain(cfg, dev) -> tuple:
    """Phase 7: one train step (epoch 1, past start_epoch) from one state
    with the kernels and with the plain pair, cuDNN deterministic. Returns
    the state, the step and its batch, for the profile phase."""
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain,
                                               bn_functions, bn_stats,
                                               bn_stats_plain)
    from stil_tta_torch.train.optim import set_learning_rate
    src = load_sources(cfg)
    src_l, src_u = src["train_labelled"], src["train_unlabelled"]
    algo = STiL(cfg, src_l.field_lengths, device=dev)
    cache_l = DeviceCache(src_l, device=dev).as_dict()
    cache_u = DeviceCache(src_u, device=dev).as_dict()
    b_l = int(cfg.batch_size) // (1 + int(cfg.unlabelled_ratio))
    batch = (cache_l, cache_u, torch.arange(b_l, device=dev),
             torch.arange(int(cfg.batch_size) - b_l, device=dev))
    state = algo.init_state(0)
    net0 = copy.deepcopy(state.net.state_dict())
    ema0 = copy.deepcopy(state.ema.state_dict())
    rng0 = torch.cuda.get_rng_state()
    step = algo.make_train_step()
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, fns in (("kernel", (bn_stats, bn_bwd_reduce)),
                      ("plain", (bn_stats_plain, bn_bwd_reduce_plain))):
        state = algo.init_state(0)
        state.net.load_state_dict(net0)
        state.ema.load_state_dict(ema0)
        torch.cuda.set_rng_state(rng0)
        set_learning_rate(state.optimizer, STEP_LR)
        with bn_functions(state.net, *fns):
            step(state, *batch, 1)
        torch.cuda.synchronize()
        net = state.net
        runs[name] = {
            "loss": float(state.log_sums["loss"]),
            "params": _clone(net.named_parameters()),
            "grads": _clone((k, p.grad) for k, p in net.named_parameters()),
            "stats": _clone((k, b) for k, b in net.named_buffers()
                            if k.endswith(("running_mean", "running_var")))}
    torch.backends.cudnn.deterministic = False
    k, p = runs["kernel"], runs["plain"]

    def rel_l2(a: dict, b: dict, base: dict = None) -> float:
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in a)
        den = sum(float(((b[n] - (0 if base is None else base[n])) ** 2)
                        .sum()) for n in b)
        return math.sqrt(num / max(den, 1e-30))

    p0 = {n: net0[n].float() for n in p["params"]}
    d_loss = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    d_grad = rel_l2(k["grads"], p["grads"])
    d_upd = rel_l2(k["params"], p["params"], p0)
    d_upd_max = max(float((k["params"][n] - p["params"][n]).abs().max())
                    for n in p0) / STEP_LR
    d_mean = max(float(((k["stats"][n] - p["stats"][n]).abs()
                        / p["stats"][n[:-4] + "var"].clamp_min(1e-12).sqrt())
                       .max()) for n in k["stats"] if n.endswith("mean"))
    d_var = max(float(((k["stats"][n] - p["stats"][n]).abs()
                       / p["stats"][n].clamp_min(1e-12)).max())
                for n in k["stats"] if n.endswith("var"))
    log(f"[step] one train step, kernels vs plain (epoch 1, lr {STEP_LR}): "
        f"loss {k['loss']:.6f} vs {p['loss']:.6f} (rel {d_loss:.2e}, tol "
        f"1e-2); gradients rel L2 {d_grad:.3e} (tol 0.1); parameter "
        f"updates rel L2 {d_upd:.3e} (tol 0.5), largest element difference "
        f"{d_upd_max:.3f} x lr; BN running stats max |d mean|/std "
        f"{d_mean:.3e}, max |d var|/var {d_var:.3e} (tol 0.1)")
    # bfloat16 activations: the pairs differ by float32 summation order,
    # which flips bf16 roundings that carry through the layers; Adam's
    # first step is about lr * sign(g), so a gradient element near 0 can
    # move its parameter the other way (2 x lr)
    if (d_loss > 1e-2 or d_grad > 0.1 or d_upd > 0.5
            or max(d_mean, d_var) > 0.1):
        raise SystemExit("kernel and plain train steps disagree")
    return state, step, batch


def profile_train_step(state, step, batch) -> dict:
    """Phase 8: one train step under the profiler, and one more on the
    host's clock alone. BN's forward and backward run inside named ranges
    (a subclass of the Function, for this phase only), so the device time
    of their elementwise kernels can be read off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from stil_tta_torch.ops import batch_norm as bn_mod
    base = bn_mod.BNTrain

    class Ranged(base):
        @staticmethod
        def forward(ctx, *args):
            with record_function("bn_train.forward"):
                return base.forward(ctx, *args)

        @staticmethod
        def backward(ctx, *grads):
            with record_function("bn_train.backward"):
                return base.backward(ctx, *grads)

    step(state, *batch, 1)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[1]
    bn_mod.BNTrain = Ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, *batch, 1)
            torch.cuda.synchronize()
            prof_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bn_mod.BNTrain = base
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    # kernels only: ranges (ours, the optimizer's) also appear on the
    # device timeline and would count their kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith(("bn_train.", "Optimizer."))]
    busy = sum(dev_time(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    part = lambda tag: sum(dev_time(e) for e in events  # noqa: E731
                           if tag in e.key) / 1e3
    # bn_stats is one kernel a call; bn_bwd_reduce's second pass is
    # bn_reduce::column_sums_kernel
    stats_ms = part("bn_stats_kernel")
    bwd_ms = part("bn_bwd_partial") + part("column_sums")

    def kernels_under(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from kernels_under(ch)

    ours = ("bn_stats_kernel", "bn_bwd_partial", "column_sums")
    elem_ms = sum(k.duration for e in prof.events()
                  if e.name.startswith("bn_train.")
                  and e.device_type == DeviceType.CPU
                  for k in kernels_under(e)
                  if not any(t in k.name for t in ours)) / 1e3
    out = {"host_ms": host_ms, "profiled_host_ms": prof_host_ms,
           "busy_ms": busy, "bn_stats_ms": stats_ms,
           "bn_bwd_reduce_ms": bwd_ms, "bn_elementwise_ms": elem_ms,
           "kernel_launches": n_kernels}
    log(f"[profile] train step: host clock {host_ms:.3f} ms (median of "
        f"{', '.join(f'{t:.3f}' for t in host)}; profiled "
        f"{prof_host_ms:.3f} ms), device busy {busy:.3f} ms, idle share "
        f"{1 - busy / host_ms:.1%}; {n_kernels} kernel launches, "
        f"{host_ms / max(n_kernels, 1) * 1e3:.1f} us of host clock each")
    for name, ms in (("bn_stats", stats_ms), ("bn_bwd_reduce", bwd_ms),
                     ("BN elementwise (fwd + bwd)", elem_ms)):
        log(f"[profile]   {name}: {ms:.3f} ms ({ms / max(busy, 1e-9):.1%} "
            f"of device busy)")
    for e in sorted(events, key=dev_time, reverse=True)[:8]:
        log(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    return out


def tta_strategies_full_width() -> None:
    """Phase 10: ``test()`` with Tent, EATA and SAR at full width, then
    ``adapt`` alone on fresh weights to see what it ran and changed."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import bn_stats
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    from stil_tta_torch.tta.tent import bn_parameters
    for strategy in ("tent", "eata", "sar"):
        cfg = load_config("config_dvm_STiL", TEST_OVERRIDES + [
            f"tta_strategy={strategy}", TTA_MARGIN,
            f"logdir=runs/chip_smoke_{strategy}"])
        torch.cuda.synchronize()
        bn_stats.launches = 0
        t0 = time.perf_counter()
        metrics = test(cfg.copy(), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bn_stats.launches
        batches = math.ceil(int(cfg.synthetic_test) / int(cfg.batch_size))
        log(f"[tta] {strategy}: metrics {json.dumps(metrics)}; test() "
            f"{wall:.3f} s (data synthesis, weight init, adaptation, "
            f"scoring); bn_stats launches {launches} (53 x {batches})")
        if launches != 53 * batches:
            raise SystemExit(f"{strategy}: bn_stats launch count off the "
                             "stats phase")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0
                   for v in metrics.values()):
            raise SystemExit(f"{strategy}: bad test metrics {metrics}")

        src = load_test_split(cfg)
        algo = build_algo(cfg, src.field_lengths, "cuda")
        cache = DeviceCache(src, device="cuda").as_dict()
        before = {k: v.detach().clone()
                  for k, v in algo.net.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = adapt(cfg, algo, cache)
        torch.cuda.synchronize()
        t_adapt = time.perf_counter() - t0
        bn_names = {k for k, _ in bn_parameters(algo.net)}
        stats = ("running_mean", "running_var", "num_batches_tracked")
        after = algo.net.state_dict()
        changed = {k for k, v in after.items()
                   if not torch.equal(v, before[k])}
        stray = sorted(k for k in changed
                       if k not in bn_names and not k.endswith(stats))
        moved = max(float((after[k] - before[k]).abs().max())
                    for k in bn_names)
        log(f"[tta] {strategy}: adapt {t_adapt * 1e3:.1f} ms, {counts}; "
            f"{len(changed & bn_names)} of {len(bn_names)} BN affine "
            f"tensors changed, largest move {moved:.3e} "
            f"(lr {float(cfg.tta_lr):.0e}); other parameters changed: "
            f"{stray or 'none'}")
        if stray or not math.isfinite(moved):
            raise SystemExit(f"{strategy}: adaptation changed {stray}")
        if counts.get("selected", 1) == 0 or moved == 0.0:
            raise SystemExit(f"{strategy}: the adaptation did no work")
        del algo, cache, src


def ptxas_report(source: str) -> dict:
    """Registers, shared memory and spills of each kernel entry of a built
    source, from its ``-Xptxas -v`` report: {mangled name: summary}."""
    from stil_tta_torch.ops import cuda_build
    report, entry = {}, None
    for line in cuda_build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("spill" in line or "Used" in line):
            report[entry] = f"{report.get(entry, '')} {line.strip()}".strip()
    return report


def probe_phase() -> list:
    """Phase 11: the probe's kernels against their plain versions, then
    its entry point with the launch counts read around it; returns the
    record rows of the three kernels."""
    from stil_tta_torch.ops.conv_chain import (conv_bwd_join, conv_chain,
                                               conv_chain_scratch)
    from stil_tta_torch.tools import bench_conv_probe as probe
    t0 = time.perf_counter()
    chain_in = probe.make_inputs("cuda")
    join_in = probe.make_join_inputs("cuda")
    log(f"[probe] inputs M={probe.M} K={probe.K} N={probe.N} "
        f"NJ={probe.NJ} (numpy RandomState, seeds 0 and 1) in "
        f"{time.perf_counter() - t0:.1f} s")
    max_abs = collections.defaultdict(float)
    m_r = probe.M - RAGGED
    for name in probe.KERNELS:
        inputs = join_in if name == "conv_bwd_join" else chain_in
        ragged = tuple(t[:m_r] if t.dim() == 2 and t.shape[0] == probe.M
                       else t for t in inputs)
        for m, args in ((probe.M, inputs), (m_r, ragged)):
            check = probe.check_kernel(name, args)
            log(f"[probe] {name} M={m:,d} vs plain: {json.dumps(check)} "
                f"(tol: at most {probe.ULP_SHARE:.0e} of outputs differ, "
                f"each by <= {check['ulp_limit']} ulp; sums "
                f"{probe.SUM_TOL:.0e} of sum|.|)")
            if not probe.passes(check):
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at M={m}")
            max_abs[name] = max(max_abs[name], check["max_abs_err"])

    kernels = {"conv_chain": conv_chain,
               "conv_chain_scratch": conv_chain_scratch,
               "conv_bwd_join": conv_bwd_join}
    for fn in kernels.values():
        fn.launches = 0
    result = probe.run(chain_in, join_in,
                       log=lambda line: log(f"[probe] {line}"))
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[probe] launches in the probe's run {launches}")
    if min(launches.values()) == 0:
        raise SystemExit("a probe kernel was not launched by the probe")

    dy_up, w1 = join_in[:2]
    plain_ms = {name: probe.measure(
        lambda fn=plain, a=(join_in if name == "conv_bwd_join"
                            else chain_in): fn(*a))
        for name, (_, plain) in probe.KERNELS.items()}
    gemm_join = probe.measure(lambda: torch.matmul(dy_up, w1.T))
    ms = result["ms"]
    log(f"[probe] plain versions {json.dumps(plain_ms)} ms; join GEMM "
        f"torch.matmul(dy_up, w1.T) {gemm_join:.4f} ms")
    from stil_tta_torch.ops.conv_chain import _plan
    plans = {"conv_chain": _plan(probe.K, probe.N),
             "conv_bwd_join": _plan(probe.N, probe.NJ, join=True)}
    # the kernel entries: conv_chain_kernel<false>, <true>, the join's
    entries = {"conv_chain": "conv_chain_kernelILb0",
               "conv_chain_scratch": "conv_chain_kernelILb1",
               "conv_bwd_join": "conv_bwd_join_kernel"}
    rows = []
    for name, variant, lib, line in (
            ("conv_chain", "pallas_chain", ms["gemm"], 100),
            ("conv_chain_scratch", "pallas_chain_scratch", ms["gemm"], 165),
            ("conv_bwd_join", "pallas_bwd_join", gemm_join, 277)):
        source = "conv_bwd_join" if name == "conv_bwd_join" else "conv_chain"
        bound, by = result["bounds"]["join" if "join" in name else "chain"]
        ptxas = [v for k, v in ptxas_report(source).items()
                 if entries[name] in k]
        plan = plans[source]
        log(f"[probe] {name}: {ms[variant]:.4f} ms, {bound / ms[variant]:.1%}"
            f" of the {bound:.4f} ms bound; ptxas: {' | '.join(ptxas)}; "
            f"dynamic shared memory {plan['smem']:,d} bytes, "
            f"{plan['stages']} stages of {plan['stage_bytes']:,d}")
        if not ptxas:
            raise SystemExit(f"no ptxas report for {name}")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"stil_tta_torch/csrc/{source}.cu",
            "replaces": f"tools/bench_conv_probe.py:{line}",
            "launches": launches[name], "max_abs_err": max_abs[name],
            "ms": ms[variant], "plain_ms": plain_ms[name],
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library_call": "torch.matmul of the same product: GEMM only, "
                            "not the same function"})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # ---- 2. build, one nvcc for each source, all started together
    from stil_tta_torch.ops import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(cuda_build.build, SOURCES))
    build_s = time.perf_counter() - t0
    for name, lib in zip(SOURCES, libs):
        log(f"[build] {lib.name} (all built in {build_s:.2f} s)")
        for line in cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel against plain at every ResNet-50 BN shape
    from stil_tta_torch.ops.batch_norm import bn_stats, bn_stats_plain
    shapes = resnet50_bn_shapes(dev)
    assert len(shapes) == 53, len(shapes)
    per_forward = collections.Counter(shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in per_forward:
            x = (torch.randn(m, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            s, ss = bn_stats(x)
            s2, ss2 = bn_stats(x)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(s, s2) and torch.equal(ss, ss2))
            ps, pss = bn_stats_plain(x)
            scale = x.float().abs().sum(0, keepdim=True)
            rel = max(float(((s - ps).abs() / scale).max()),
                      float(((ss - pss).abs() / pss).max()))
            abs_err = max(float((s - ps).abs().max()),
                          float((ss - pss).abs().max()))
            max_abs = max(max_abs, abs_err)
            ok = bitwise and rel < TOL
            log(f"[kernel] {str(dtype)[6:]:8s} M={m:>9,d} C={c:>5d} "
                f"max rel err {rel:.2e} (tol {TOL:.0e}) abs {abs_err:.3e} "
                f"bitwise-repeat {bitwise}")
            if not ok:
                raise SystemExit(f"bn_stats disagrees at {(m, c, dtype)}")
            del x
    max_abs_bwd = check_bwd_kernel(per_forward, gen, dev)
    check_bn_function(gen, dev)

    # ---- 4. the slice at full width
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    overrides = TEST_OVERRIDES + ["tta_strategy=bn_adapt",
                                  "logdir=runs/chip_smoke"]
    cfg = load_config("config_dvm_STiL", overrides)
    log(f"[slice] {cfg.model} img {cfg.img_size} tabular "
        f"{cfg.tabular_transformer_num_layers}x{cfg.tabular_embedding_dim} "
        f"fusion {cfg.multimodal_transformer_num_layers}x"
        f"{cfg.multimodal_embedding_dim} classes {cfg.num_classes} "
        f"batch {cfg.batch_size} test {cfg.synthetic_test}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bn_stats.launches = 0
    t0 = time.perf_counter()
    metrics = test(cfg.copy(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bn_stats.launches
    peak = torch.cuda.max_memory_allocated()
    stats_batches = math.ceil(int(cfg.synthetic_test) / int(cfg.batch_size))
    log(f"[slice] metrics {json.dumps(metrics)}")
    log(f"[slice] bn_stats launches {launches} (53 x {stats_batches} stats "
        f"batches = {53 * stats_batches}); wall {wall:.3f} s "
        f"(first call: includes data synthesis, weight init and cuDNN "
        f"warm-up); peak memory {peak / 2**30:.3f} GiB")
    if launches != 53 * stats_batches:
        raise SystemExit("bn_stats launch count off the main path")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in metrics.values()):
        raise SystemExit(f"bad test metrics {metrics}")

    # same adaptation, kernel statistics against plain statistics
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, "cuda")
    cache = DeviceCache(src, device="cuda").as_dict()
    init_state = copy.deepcopy(algo.net.state_dict())
    step = algo.make_eval_step()
    idx = torch.arange(int(cfg.batch_size), device=dev)
    runs = {}
    for name, fn in (("kernel", bn_stats), ("plain", bn_stats_plain)):
        algo.net.load_state_dict(init_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adapt(cfg, algo, cache, stats=fn)
        torch.cuda.synchronize()
        t_adapt = time.perf_counter() - t0
        t0 = time.perf_counter()
        prob = step(cache, idx)["prob_m"].float()
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        bufs = {k: v.float().clone() for k, v in
                algo.net.state_dict().items() if k.endswith(
                    ("running_mean", "running_var"))}
        runs[name] = (bufs, prob, t_adapt, t_eval)
        log(f"[slice] adapt with {name} statistics: {t_adapt * 1e3:.1f} ms "
            f"({stats_batches} batches), eval batch {t_eval * 1e3:.1f} ms")
    kb, kp = runs["kernel"][:2]
    pb, pp = runs["plain"][:2]
    # a running mean's difference in units of its channel's std, a
    # running variance's relative to itself
    d_mean = max(float(((kb[k] - pb[k]).abs()
                        / pb[k[:-4] + "var"].clamp_min(1e-12).sqrt()).max())
                 for k in kb if k.endswith("mean"))
    d_var = max(float(((kb[k] - pb[k]).abs() / pb[k].clamp_min(1e-12)).max())
                for k in kb if k.endswith("var"))
    d_prob = float((kp - pp).abs().max())
    finite = all(bool(torch.isfinite(v).all()) for v in kb.values())
    rows = float((kp.sum(1) - 1).abs().max())
    log(f"[slice] adapted running stats, kernel vs plain ({len(kb)} "
        f"buffers): max |d mean|/std {d_mean:.3e}, max |d var|/var "
        f"{d_var:.3e}; prob_m max abs diff {d_prob:.3e}; prob rows sum to "
        f"1 within {rows:.1e}")
    if not finite or not bool(torch.isfinite(kp).all()) or rows > 1e-3:
        raise SystemExit("non-finite adapted statistics or probabilities")
    # bfloat16 activations: the two runs differ only by float32 summation
    # order in the statistics, which can flip a bf16 rounding of a
    # channel's mean or variance (0.4%) and then carries through the
    # following layers
    if max(d_mean, d_var) > 0.1 or d_prob > 0.05:
        raise SystemExit("kernel and plain adaptation disagree")

    # where the BN-adapt pass spends device time
    from torch.profiler import ProfilerActivity, profile
    algo.net.load_state_dict(init_state)
    torch.cuda.synchronize()
    bn_stats.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adapt(cfg, algo, cache)
        torch.cuda.synchronize()
    profiled_launches = bn_stats.launches
    # kernel events only: operator rows repeat their kernels' time
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in events)
    bn_us = sum(dev_time(e) for e in events if "bn_stats_kernel" in e.key)
    bn_events = sum(e.count for e in events if "bn_stats_kernel" in e.key)
    # bn_stats is one kernel a call: no second pass runs in this pass
    pass2 = sum(e.count for e in events if "column_sums" in e.key)
    log(f"[profile] BN-adapt pass: device busy {busy_us / 1e3:.3f} ms, "
        f"bn_stats kernels {bn_us / 1e3:.3f} ms "
        f"({bn_us / max(busy_us, 1e-9):.1%}); {bn_events} bn_stats kernel "
        f"events for {profiled_launches} launches "
        f"({53 * stats_batches} expected), {pass2} column_sums kernels")
    if not bn_events == profiled_launches == 53 * stats_batches or pass2:
        raise SystemExit("bn_stats is not one kernel a call in the BN-adapt "
                         "pass")
    top = sorted(events, key=dev_time, reverse=True)[:8]
    for e in top:
        log(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")

    # ---- 5. serving
    from stil_tta_torch.serve import Predictor
    import numpy as np
    pred = Predictor(algo, batch_size=512)
    images, tabular = np.asarray(src.images), np.asarray(src.tabular)
    pred(images[:512], tabular[:512])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = pred(images, tabular)
    serve_s = time.perf_counter() - t0
    sps = len(images) / serve_s
    log(f"[serve] Predictor batch 512: {len(images)} samples in "
        f"{serve_s * 1e3:.1f} ms = {sps:.1f} samples/s (host arrays in, "
        f"probabilities out)")
    if probs.shape != (len(images), int(cfg.num_classes)) \
            or not np.isfinite(probs).all():
        raise SystemExit("bad serving output")
    adapt_launches = launches
    del algo, cache, pred, src, runs

    # ---- 6. training at full width
    train_cfg, launches = train_full_width()

    # ---- 7. one train step with the kernels and with the plain pair
    state, step, batch = train_step_kernel_vs_plain(train_cfg, dev)

    # ---- 8. profile of one train step
    profile_train_step(state, step, batch)
    del state, step, batch

    # ---- 9. timing per shape (bfloat16, the path's dtype)
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain,
                                               bn_stats_plan)
    ptxas = ptxas_report("bn_stats")
    for entry, report in ptxas.items():
        log(f"[time] bn_stats ptxas {entry}: {report}")
    if not any("bn_stats_kernel" in k for k in ptxas):
        raise SystemExit("no ptxas report for bn_stats")
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # a flush that reads: L2 then holds clean lines only
    clean = torch.ones(64 * 2**20, device=dev)
    lib_fn = lambda x: torch.batch_norm_stats(x, 1e-5)  # noqa: E731
    tot = collections.defaultdict(float)
    bytes_fwd = 0
    ops_fwd = 0
    for (m, c), n in per_forward.items():
        x = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        t_k = time_ms(bn_stats, x, buf)
        t_p = time_ms(bn_stats_plain, x, buf)
        t_l = time_ms(lib_fn, x, buf)
        t_c = time_ms(bn_stats, x, buf, flush=clean.sum)
        nbytes = m * c * 2 + 2 * c * 4
        nops = 3 * m * c
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3
        plan = bn_stats_plan(x)
        log(f"[time] M={m:>9,d} C={c:>5d} x{n:<2d} kernel {t_k:.4f} ms "
            f"bound {bound:.4f} ms ({bound / t_k:.1%} of bound) plain "
            f"{t_p:.4f} ms batch_norm_stats {t_l:.4f} ms; kernel after a "
            f"reading flush {t_c:.4f} ms ({bound / t_c:.1%}); plan grid "
            f"{plan.grid}, {plan.tiles} tile(s) of {plan.tile_c} x "
            f"{plan.chunks} chunks of {plan.rows_per_chunk} rows, "
            f"{plan.stages} stages of {plan.stage_rows} rows "
            f"({plan.stage_bytes:,d} bytes), {plan.chunks} partial "
            f"rows, smem {plan.smem:,d}")
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] += n * t_l
        tot["clean_ms"] += n * t_c
        tot["bound_ms"] += n * bound
        bytes_fwd += n * nbytes
        ops_fwd += n * nops
        del x
    bound_by = ("bytes" if bytes_fwd / HBM_BYTES_PER_S
                >= ops_fwd / F32_FLOPS else "operations")
    log(f"[time] one forward (53 BNs, batch 512): kernel {tot['ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({bytes_fwd / 1e9:.3f} GB; the "
        f"kernel at {tot['bound_ms'] / tot['ms']:.1%} of it), plain "
        f"{tot['plain_ms']:.4f} ms, batch_norm_stats "
        f"{tot['library_ms']:.4f} ms; kernel after a reading flush "
        f"{tot['clean_ms']:.4f} ms ({tot['bound_ms'] / tot['clean_ms']:.1%})")
    del clean
    # the cost of a call that moves almost no bytes: one row a block,
    # beside one elementwise kernel on the same input
    x = torch.randn(132, 256, generator=gen, device=dev).to(torch.bfloat16)
    log(f"[time] per-call floor at M=132 C=256: bn_stats "
        f"{time_ms(bn_stats, x, buf) * 1e3:.2f} us, x.add_(0) "
        f"{time_ms(lambda t: t.add_(0), x, buf) * 1e3:.2f} us")

    # bn_bwd_reduce: x and dy read once, mean and inv read, two sums out
    lib_bwd = lambda t: torch.batch_norm_backward_reduce(  # noqa: E731
        t[1], t[0], t[2], t[3], t[4], True, True, True)
    tot_b = collections.defaultdict(float)
    bytes_bwd = 0
    ops_bwd = 0
    for (m, c), n in per_forward.items():
        x = (torch.randn(m, c, generator=gen, device=dev)
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        mean = x.float().mean(0)
        inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
        weight = torch.ones(c, device=dev)
        args = (x, dy, mean, inv, weight)
        t_k = time_ms(lambda t: bn_bwd_reduce(*t[:4]), args, buf)
        t_p = time_ms(lambda t: bn_bwd_reduce_plain(*t[:4]), args, buf)
        t_l = time_ms(lib_bwd, args, buf)
        nbytes = 2 * m * c * 2 + 4 * c * 4
        nops = 5 * m * c
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3
        log(f"[time] bwd M={m:>9,d} C={c:>5d} x{n:<2d} kernel {t_k:.4f} ms "
            f"bound {bound:.4f} ms ({bound / t_k:.0%} of bound) plain "
            f"{t_p:.4f} ms batch_norm_backward_reduce {t_l:.4f} ms")
        tot_b["ms"] += n * t_k
        tot_b["plain_ms"] += n * t_p
        tot_b["library_ms"] += n * t_l
        tot_b["bound_ms"] += n * bound
        bytes_bwd += n * nbytes
        ops_bwd += n * nops
        del x, dy, args
    bound_by_b = ("bytes" if bytes_bwd / HBM_BYTES_PER_S
                  >= ops_bwd / F32_FLOPS else "operations")
    log(f"[time] one backward (53 BNs, batch 512): kernel "
        f"{tot_b['ms']:.4f} ms, bound {tot_b['bound_ms']:.4f} ms "
        f"({bytes_bwd / 1e9:.3f} GB), plain {tot_b['plain_ms']:.4f} ms, "
        f"batch_norm_backward_reduce {tot_b['library_ms']:.4f} ms")
    log(f"[time] launches: BN-adapt slice bn_stats {adapt_launches}; "
        f"training {launches} (the record's counts)")
    del buf

    # ---- 10. TTA strategies at full width
    tta_strategies_full_width()

    # ---- 11. the conv+BN probe
    probe_rows = probe_phase()

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "bn_stats", "route": "cuda",
        "source": "stil_tta_torch/csrc/bn_stats.cu",
        "replaces": "stil_tta_tpu/ops/batch_norm.py:61",
        "launches": launches["bn_stats"], "max_abs_err": max_abs,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": bound_by,
        "library_ms": tot["library_ms"]}, {
        "name": "bn_bwd_reduce", "route": "cuda",
        "source": "stil_tta_torch/csrc/bn_bwd_reduce.cu",
        "replaces": "stil_tta_tpu/ops/batch_norm.py:97",
        "launches": launches["bn_bwd_reduce"], "max_abs_err": max_abs_bwd,
        "ms": tot_b["ms"], "plain_ms": tot_b["plain_ms"],
        "bound_ms": tot_b["bound_ms"], "bound_by": bound_by_b,
        "library_ms": tot_b["library_ms"]}] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
